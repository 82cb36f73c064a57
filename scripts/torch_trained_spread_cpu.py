"""The spread of the trained CSL endpoints of ``tests/test_torch_e2e.py``
on the CPU, where each endpoint differs only in float32 summation order,
and how far one endpoint's int8 graph moves with that order.

Usage, from the repository root (no card needed; ~17 min on 8 cores):

    python3 scripts/torch_trained_spread_cpu.py

The slow test trains YOLOv5-CSL with the recipe of
``tests/test_trained_parity.py`` on 2 threads, where the port's CPU run is
deterministic.  This script trains the same recipe on the same data in
child processes that differ only in how the CPU sums (``SETTINGS``): 1, 2
(the test's endpoint, the control), 3 and 4 threads with oneDNN's
convolutions, and 2 threads with oneDNN off (PyTorch's own convolutions),
and prints each endpoint's mAP@.5 / mAP@.5:.95 on the val split and on the
training images (``chip_smoke.py`` phase 19 sets its floors from these and
from the card's endpoints).  Then, in a child for each setting, it runs
the control endpoint's fused float32 graph and its int8 graph (dynamic
scales, float32 compute) on the 4 val images and prints each graph's
decoded rows against the control setting's as ``chip_smoke.py`` phase 19
holds the card's against the CPU's (:func:`chip_smoke.int8_gaps`), and
the control setting's rows on the images nudged up by one float32 ulp
against its rows on the images as they are.
"""

import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# (threads, oneDNN convolutions); the first is the control
SETTINGS = ((2, True), (1, True), (3, True), (4, True), (2, False))


def train(root, threads, mkldnn):
    """Train the recipe in this process and print the endpoint's mAPs; the
    control's weights go to ``<root>/control.pt``."""
    from tests.test_torch_e2e import IMG, NAMES, port_eval, train_port

    model, _ = train_port(root, "csl")
    if (threads, mkldnn) == SETTINGS[0]:
        torch.save(model.state_dict(), os.path.join(root, "control.pt"))
    out = []
    for split in ("val", "train"):
        data = {"val": os.path.join(root, split), "names": NAMES,
                "type": "custom"}
        maps = port_eval(model, data, "csl", IMG, 4)
        out.append(f"{split} {maps[2]:.6f} / {maps[3]:.6f}")
    print(f"cpu endpoint, {threads} threads, oneDNN "
          f"{'on' if mkldnn else 'off'}: " + "; ".join(out), flush=True)


def rows(root, threads, mkldnn):
    """The control's float32 and int8 decoded rows on the val images in
    this process's summation order, to ``<root>/rows_<threads>_<mkldnn>``;
    in the control setting also on the images nudged by one ulp, to
    ``<root>/rows_nudged``."""
    from ryolo_tpu_torch.nn import Yolo
    from tests.test_torch_e2e import HYP, MODEL_CFG, NC

    model = Yolo(NC, MODEL_CFG, mode="csl", ver="yolov5")
    model.load_state_dict(torch.load(os.path.join(root, "control.pt")))
    x = cs.trained_images({"hyp": HYP}, os.path.join(root, "val"), "csl",
                          cs.TRAINED_SET["img_size"], cs.TRAINED_BATCH)
    torch.save(cs.graph_rows(model.eval(), x, "cpu"),
               os.path.join(root, f"rows_{threads}_{int(mkldnn)}.pt"))
    if (threads, mkldnn) == SETTINGS[0]:
        torch.save(cs.graph_rows(model, torch.nextafter(x, torch.tensor(2.0)),
                                 "cpu"), os.path.join(root, "rows_nudged.pt"))


def main():
    if len(sys.argv) == 5:  # a child: what, root, threads, oneDNN
        threads, mkldnn = int(sys.argv[3]), sys.argv[4] == "1"
        torch.set_num_threads(threads)
        torch.backends.mkldnn.enabled = mkldnn
        {"train": train, "rows": rows}[sys.argv[1]](sys.argv[2], threads,
                                                     mkldnn)
        return 0

    def run(what):
        children = [subprocess.Popen(
            [sys.executable, __file__, what, tmp, str(threads),
             str(int(mkldnn))], cwd=REPO) for threads, mkldnn in SETTINGS]
        return max(child.wait() for child in children)

    with tempfile.TemporaryDirectory() as tmp:
        cs.write_custom_set(tmp, **cs.TRAINED_SET)
        if run("train") or run("rows"):
            return 1
        got = {s: torch.load(os.path.join(tmp, f"rows_{s[0]}_{int(s[1])}.pt"))
               for s in SETTINGS}
        want = got[SETTINGS[0]]
        for (threads, mkldnn), out in list(got.items())[1:]:
            gaps = cs.int8_gaps(out, want)
            print(f"control endpoint, {threads} threads, oneDNN "
                  f"{'on' if mkldnn else 'off'}, against 2 threads, oneDNN "
                  "on: " + cs.fmt_gaps(gaps), flush=True)
        nudged = torch.load(os.path.join(tmp, "rows_nudged.pt"))
        print("control endpoint, 2 threads, oneDNN on, the val images nudged "
              "by one ulp, against the images as they are: "
              + cs.fmt_gaps(cs.int8_gaps(nudged, want)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
