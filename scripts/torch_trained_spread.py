"""The spread of the trained endpoints of ``chip_smoke.py`` phase 19.

Usage, from the repository root on a machine with a CUDA card:

    python3 scripts/torch_trained_spread.py

Phase 19 trains YOLOv5 (nc = 2) on the synthetic set with the recipe of
``tests/test_trained_parity.py`` and scores one endpoint.  Runs of the
recipe differ only in float32 rounding (the card's backward sums in no fixed
order), and their endpoints part.  This script trains the recipe
``RUNS`` times for each head on ``cuda:0`` with phase 19's functions and
prints, for each endpoint, mAP@.5 / mAP@.5:.95 and the detections matched
of: the val split in float32 and int8 (the float32 graph with the wide
convs int8) on the card and in int8 on the CPU, the training images in
float32, and the dense 192 px split of ``tests/test_trained_parity.py``
(:310-323: 4 images, 60-80 targets each).
"""

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

RUNS = {"csl": 4, "kfiou": 2}
DENSE = dict(n_images=4, img_size=192, w_range=(0.09, 0.14), ratio=(1.2, 1.6),
             min_obj=60, max_obj=81)


def main():
    import ryolo_tpu_torch.eval.evaluator as ev
    from ryolo_tpu_torch.utils.config import load_yaml

    cs.phase_device()
    cs.phase_build()
    cfg = load_yaml(os.path.join(REPO, "configs", "hyp.yaml"))
    matched = [0]
    stats = ev.get_batch_statistics

    def count(outputs, *a):
        matched[0] += sum(len(o) for o in outputs)
        return stats(outputs, *a)

    ev.get_batch_statistics = count
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "synth")
        cs.write_custom_set(root, **cs.TRAINED_SET)
        kw = dict(DENSE)
        n, img = kw.pop("n_images"), kw.pop("img_size")
        dense = os.path.join(tmp, "dense")
        cs.write_custom_split(dense, n, img, np.random.default_rng(23), **kw)

        def split(path):
            return {"val": path, "names": cs.SYNTH_NAMES, "type": "custom"}

        # (key, split, device, quantize, image size, batch, max targets)
        evals = (("val f32", split(os.path.join(root, "val")), "cuda", False,
                  cs.TRAINED_SET["img_size"], cs.TRAINED_BATCH, 32),
                 ("val int8", split(os.path.join(root, "val")), "cuda", True,
                  cs.TRAINED_SET["img_size"], cs.TRAINED_BATCH, 32),
                 ("val cpu int8", split(os.path.join(root, "val")), "cpu",
                  True, cs.TRAINED_SET["img_size"], cs.TRAINED_BATCH, 32),
                 ("training images f32", split(os.path.join(root, "train")),
                  "cuda", False, cs.TRAINED_SET["img_size"],
                  cs.TRAINED_BATCH, 32),
                 ("dense f32", split(dense), "cuda", False, img, 2, 96))
        for mode, runs in RUNS.items():
            for run in range(runs):
                model = cs.trained_model_train(root, cfg, mode)
                out = []
                for key, data, device, quantize, size, batch, targets in evals:
                    matched[0] = 0
                    maps, _ = cs.trained_eval(model, cfg, data, mode, device,
                                              None, quantize, size, batch,
                                              targets)
                    out.append(f"{key} {maps[2]:.6f} / {maps[3]:.6f} "
                               f"({matched[0]} matched)")
                print(f"spread yolov5-{mode} run {run + 1}: " + "; ".join(out),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
