"""Where ``chip_smoke.py``'s time goes, function by function.

Runs ``chip_smoke.main()`` in this process while a thread samples the main
thread's Python stack every ``INTERVAL_S`` seconds. For each function of
``chip_smoke.py`` it adds the interval once per sample in which the
function is on the stack (inclusive time), and writes the totals, largest
first, to ``chiprun_out/smoke_profile.json``; ``chip_smoke.py``'s own
output is unchanged. The sampling costs one stack walk a half second.

    python3 tools/smoke_profile.py          # on the GPU machine
"""
import json
import sys
import threading
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INTERVAL_S = 0.5


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    target = str(ROOT / "chip_smoke.py")
    main_id = threading.get_ident()
    inclusive: Counter = Counter()
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(INTERVAL_S):
            frame = sys._current_frames().get(main_id)
            seen = set()
            while frame is not None:
                code = frame.f_code
                if code.co_filename == target and code.co_name not in seen:
                    seen.add(code.co_name)
                    inclusive[code.co_name] += INTERVAL_S
                frame = frame.f_back

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    sys.argv = [target]
    t0 = time.perf_counter()
    try:
        rc = chip_smoke.main()
    finally:
        stop.set()
        sampler.join()
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "smoke_profile.json").write_text(json.dumps(dict(
            wall_s=time.perf_counter() - t0, interval_s=INTERVAL_S,
            inclusive_s=dict(inclusive.most_common())), indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
