"""The build table of the port's CUDA kernels (``repro_torch.kernels._build.LIBS``)
against the sources on disk, read as text: no ``nvcc`` is run.

A library's file name carries a hash of its source and the headers it
lists, so a header that a kernel includes but the table leaves out would
keep a stale library after an edit; a header no library lists is dead
code."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import _build

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _includes(path: Path) -> set:
    """The quoted includes of ``path``, followed through the headers they
    include (names relative to its csrc directory)."""
    seen, todo = set(), [path]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            if name not in seen:
                seen.add(name)
                header = path.parent / name
                assert header.is_file(), f"{path.name} includes missing {name}"
                todo.append(header)
    return seen


@pytest.mark.parametrize("name", sorted(_build.LIBS))
def test_library_headers_cover_its_includes(name):
    lib = _build.LIBS[name]
    source = lib.path(lib.source)
    assert source.is_file(), source
    for header in lib.headers:
        assert lib.path(header).is_file(), f"{name}: {header} missing"
    missing = _includes(source) - set(lib.headers)
    assert not missing, f"{name}: includes {sorted(missing)} not hashed"


def test_every_header_belongs_to_a_library():
    kernels = Path(_build.__file__).resolve().parent
    listed = {lib.path(h).resolve() for lib in _build.LIBS.values()
              for h in lib.headers}
    on_disk = set(p.resolve() for p in kernels.glob("*/csrc/*.cuh"))
    assert on_disk, "no kernel headers found"
    unused = sorted(str(p.relative_to(kernels)) for p in on_disk - listed)
    assert not unused, f"headers no library builds from: {unused}"
