"""``python -m ryolo_tpu_torch.display_inputs`` against the JAX
``display_inputs.py`` on the 96 px synthetic set (tests/make_synth_data.py):
the same arguments, and the same PNGs byte for byte, each run in a
directory of its own."""

import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_pngs_equal_jax(tmp_path, monkeypatch):
    import display_inputs as jax_display
    from ryolo_tpu_torch import display_inputs
    from tests import make_synth_data

    make_synth_data.main(str(tmp_path / "synth"), n_images=6, img_size=96,
                         seed=4)
    args = Namespace(data=str(tmp_path / "synth" / "data.yaml"),
                     config=str(REPO / "configs" / "hyp.yaml"), img_size=96,
                     n=4)
    assert vars(display_inputs.build_parser().parse_args([])) == dict(
        data="configs/DOTA.yaml", config="configs/hyp.yaml", img_size=608,
        n=8)
    written = {}
    for name, main in (("jax", jax_display.main),
                       ("port", display_inputs.main)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        main(args)
        out = tmp_path / name / "outputs" / "display"
        written[name] = {f: (out / f).read_bytes()
                         for f in sorted(os.listdir(out))}
    assert len(written["port"]) == 4
    assert written["port"] == written["jax"]


def test_cli_runs(tmp_path):
    from tests import make_synth_data

    make_synth_data.main(str(tmp_path / "synth"), n_images=4, img_size=64,
                         seed=1)
    proc = subprocess.run(
        [sys.executable, "-m", "ryolo_tpu_torch.display_inputs", "--data",
         str(tmp_path / "synth" / "data.yaml"), "--config",
         str(REPO / "configs" / "hyp.yaml"), "--img_size", "64", "--n", "2"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(os.listdir(tmp_path / "outputs" / "display")) == 2
    assert proc.stdout.count("wrote ") == 2
