"""The port's roofline (``repro_torch.roofline``) against the JAX
package's: ``model_flops_estimate`` exactly for every shipped config and
phase, ``roofline_terms`` on the same cost dicts with the same constants,
``collective_bytes_from_hlo`` on a canned post-SPMD HLO text; the H100's
``HW``; and ``collective_bytes_from_mesh`` counting the payload of a known
sequence of shape-only collectives on an abstract (1, 4) mesh."""
import dataclasses

import pytest
import torch

import _torch_bridge  # noqa: F401  (one torch thread a worker)
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.roofline import HW as JHW
from repro.roofline import collective_bytes_from_hlo as jcoll
from repro.roofline import model_flops_estimate as jflops
from repro.roofline import roofline_terms as jterms
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.roofline import HW, collective_bytes_from_hlo, \
    collective_bytes_from_mesh, model_flops_estimate, roofline_terms


@pytest.mark.parametrize("name", ARCH_IDS)
def test_model_flops_equal_the_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    for phase, tokens in (("train", 256 * 4096), ("prefill", 32 * 32768),
                          ("decode", 128)):
        assert model_flops_estimate(cfg, tokens=tokens, phase=phase) == \
            jflops(jcfg, tokens=tokens, phase=phase)


@pytest.mark.parametrize("cost,coll", [
    ({"flops": 3.2e12, "bytes accessed": 7.5e9}, 0),
    ({"flops": 1e9, "bytes accessed": 4e11}, 123456789),
    ({"flops": 0.0}, 5e10), (None, 0), ({}, 1)])
def test_roofline_terms_equal_the_reference(cost, coll):
    ref_hw = dataclasses.asdict(JHW())
    assert roofline_terms(cost, coll, HW(**ref_hw)) == \
        jterms(cost, coll, JHW())


_HLO = """\
HloModule jit_step, entry_computation_layout={...}

ENTRY %main.42 (p0: bf16[8,2048], p1: f32[64,2048,1024]) -> f32[8,2048] {
  %p0 = bf16[8,2048]{1,0} parameter(0)
  %all-gather.1 = bf16[32,2048]{1,0} all-gather(bf16[8,2048]{1,0} %p0), dimensions={0}
  %all-reduce.2 = f32[8,2048]{1,0} all-reduce(f32[8,2048]{1,0} %x), to_apply=%add
  %all-reduce-start.3 = f32[128]{0} all-reduce-start(f32[128]{0} %y), to_apply=%add
  %reduce-scatter.4 = f32[2,2048]{1,0} reduce-scatter(f32[8,2048]{1,0} %z), dimensions={0}
  %all-to-all.5 = s32[4,16]{1,0} all-to-all(s32[4,16]{1,0} %w), dimensions={0}
  %collective-permute.6 = u8[1024]{0} collective-permute(u8[1024]{0} %v), source_target_pairs={{0,1}}
  ROOT %add.7 = f32[8,2048]{1,0} add(f32[8,2048]{1,0} %a, f32[8,2048]{1,0} %b)
}
"""


def test_collective_bytes_from_hlo_equals_the_reference():
    got = collective_bytes_from_hlo(_HLO)
    assert got == jcoll(_HLO)
    assert got["all-gather"] == 32 * 2048 * 2 and got["total"] > 0


def test_hw_is_the_h100s():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989e12, 3.35e12,
                                                     450e9)
    assert hw != HW(**dataclasses.asdict(JHW()))


def test_collective_bytes_from_mesh_counts_shape_only_collectives():
    mesh = Mesh({"data": 1, "model": 4})      # no world: abstract
    a = torch.empty((8, 2048), dtype=torch.float32, device="meta")
    mesh.all_reduce(a)                            # 65,536 B
    mesh.all_reduce(torch.empty((3,), device="meta"), op="max")  # 12 B
    out = mesh.all_gather_many(
        [torch.empty((2, 16), dtype=torch.bfloat16, device="meta")] * 3,
        dim=1)                                    # one gather of 2 x 192
    assert [tuple(t.shape) for t in out] == [(2, 64)] * 3
    mesh.broadcast(torch.empty((5,), dtype=torch.int64, device="meta"))
    assert mesh.collectives == 4
    got = collective_bytes_from_mesh(mesh)
    assert got == {"all-gather": 2 * 192 * 2, "all-reduce": 65536 + 12,
                   "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 0, "broadcast": 40,
                   "total": 768 + 65548 + 40}
    assert set(jcoll(_HLO)) <= set(got)
    # on a real tensor an abstract mesh still needs its world
    with pytest.raises(Exception):
        mesh.all_reduce(torch.zeros(4))
