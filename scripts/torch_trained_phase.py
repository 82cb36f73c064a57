"""``chip_smoke.py`` phase 19 alone, twice, its failed checks printed
instead of raised: the readings of two more trained endpoints.

Usage, from the repository root on a machine with a CUDA card (~7 min):

    python3 scripts/torch_trained_phase.py

Each pass trains YOLOv5-CSL and -KFIoU on the synthetic set with phase
19's recipe and runs phase 19(b) and (c) on the endpoints, as the whole
script does; the checks print ``CHECK FAILED: ...`` and the pass goes on,
so one run shows every reading that a bound was set from.
"""

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

PASSES = 2


def main():
    from ryolo_tpu_torch.utils.config import load_yaml

    failed = []

    def check(ok, what):
        if not ok:
            failed.append(str(what))
            print("CHECK FAILED:", what, flush=True)

    cs.check = check
    cs.phase_device()
    cs.phase_build()
    cfg = load_yaml(os.path.join(REPO, "configs", "hyp.yaml"))
    for _ in range(PASSES):
        with tempfile.TemporaryDirectory() as tmp:
            _, model = cs.phase_trained(tmp, cfg)
            cs.phase_trained_load(tmp, cfg, model)
    print(f"failed checks: {failed}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
