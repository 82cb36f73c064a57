"""The frozen reference against ``ryolo_tpu_torch`` on the CPU at tiny
sizes: the models' forwards (train and eval mode), the tile bank, the
render, the loss, the targets' check on the port's loader, and the NMS
check on the port's own post-process."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench import harness, synth  # noqa: E402
from h100_bench.reference import compare, labels  # noqa: E402
from h100_bench.reference.bank import tile_bank  # noqa: E402

MANIFEST = harness.load_manifest(ROOT)
CONFIGS = {c["name"]: harness.Cell(MANIFEST, w["name"], ROOT).config
           for w in MANIFEST["workloads"] for c in MANIFEST["configs"]
           if c["name"] == w["config"]}


def _port(cfg, state, train):
    from ryolo_tpu_torch.nn import Yolo

    model = Yolo(cfg["nc"], cfg["model"], mode=cfg["mode"], ver=cfg["ver"])
    model.load_state_dict(state, strict=True)
    return model.train(train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_matches_port(config, train):
    cfg = CONFIGS[config]
    ref = compare.build_model(cfg, "cpu", train=train)
    synth.seeded_weights(ref, 11, cfg["weights"], "cpu", 1.0)
    port = _port(cfg, ref.state_dict(), train)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, got = ref(x), port(x)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-5), \
            float((g - w).abs().max())


def test_seeded_weights_cover_the_model():
    cfg = CONFIGS["yolov7-csl"]
    a = compare.build_model(cfg, "cpu", train=True)
    b = compare.build_model(cfg, "cpu", train=True)
    synth.seeded_weights(a, 2**31 + 5, "normal", "cpu")
    synth.seeded_weights(b, 2**31 + 5, "normal", "cpu")
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k  # every element drawn, none left empty
    bn = a.backbone.cbs0.conv[1]
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))


@pytest.fixture(scope="module")
def loader_batch(tmp_path_factory):
    from ryolo_tpu_torch.data.loader import load_data

    cfg = CONFIGS["yolov7-csl"]
    split = tmp_path_factory.mktemp("split") / "train"
    synth.write_dota_split(str(split), cfg["names"],
                           np.random.default_rng(4), 6, 96)
    dataset, loader = load_data(
        str(split), cfg["names"], "DOTA", cfg["hyp"], True, img_size=64,
        batch_size=2, augment=True, shuffle=True, drop_last=True, seed=9,
        workers=1, device_augment=True, cache_images=True, device_cache=True)
    bank = dataset.build_tile_bank()
    files = sorted(str(p) for p in (split / "images").glob("*.png"))
    return bank, files, next(iter(loader))


def test_bank_render_and_loss_match_port(loader_batch):
    from ryolo_tpu_torch.data.device_augment import render_batch
    from ryolo_tpu_torch.train import LOSS_FNS

    bank, files, batch = loader_batch
    want_bank = tile_bank(files, 64)
    assert np.array_equal(bank, want_bank)
    bank_t = torch.from_numpy(want_bank)
    got = render_batch(batch, 2, bank=bank_t, device="cpu")
    want = compare.render(batch, bank_t, 2)
    assert torch.equal(got, want)

    cfg = CONFIGS["yolov7-csl"]
    ref = compare.build_model(cfg, "cpu", train=True)
    synth.seeded_weights(ref, 5, "normal", "cpu")
    port = _port(cfg, ref.state_dict(), True)
    tgt = {k: torch.from_numpy(batch[k]) for k in ("tgt", "tgt_csl",
                                                   "tgt_mask")}
    loss_fn = LOSS_FNS["csl"](port.anchors, cfg["nc"], cfg["hyp"], "cpu")
    got, _ = loss_fn(port(want), tgt)
    ref_loss, _ = compare.csl_loss(
        ref(want), tgt["tgt"], tgt["tgt_csl"], tgt["tgt_mask"],
        [torch.as_tensor(a) for a in ref.anchors], cfg["nc"], cfg["hyp"])
    assert torch.allclose(got, ref_loss, rtol=1e-6)


def _move_x(b):
    b["tgt"][0, 0, 1] += 2e-4


def _other_class(b):
    b["tgt"][0, 0, 0] = (b["tgt"][0, 0, 0] + 1) % 16


def _drop_last(b):
    b["tgt_mask"][0, int(b["tgt_mask"][0].sum()) - 1] = False


def _roll_csl(b):
    b["tgt_csl"][0, 0] = np.roll(b["tgt_csl"][0, 0], 1)


@pytest.mark.parametrize("fault", [None, _move_x, _other_class, _drop_last,
                                   _roll_csl],
                         ids=["sound", "moved", "class", "dropped", "csl"])
def test_targets_check_holds_the_loader(loader_batch, fault):
    """The loader's targets are the annotations that the batch's geometry
    places, and a target moved, relabelled, dropped or given another CSL
    window is found."""
    _, files, batch = loader_batch
    batch = {k: np.array(v) for k, v in batch.items() if k != "paths"}
    assert batch["tgt_mask"][0].sum() >= 1
    ann = labels.Annotations(files, CONFIGS["yolov7-csl"]["names"], 64)
    if fault is not None:
        fault(batch)
    found = sum(labels.target_faults(batch, ann, 64).values())
    assert (found == 0) if fault is None else (found > 0)


def _heads(cfg, seed):
    ref = compare.build_model(cfg, "cpu", train=False)
    synth.seeded_weights(ref, seed, "lecun", "cpu", 2.0)
    images = synth.scenes(2, 64, np.random.default_rng(seed))
    heads, _ = compare.forward_heads(ref, images, "cpu")
    return ref, heads


def test_nms_check_holds_the_port_and_catches_faults():
    from ryolo_tpu_torch.eval.postprocess import post_process_defer
    from ryolo_tpu_torch.nn import STRIDES
    from ryolo_tpu_torch.nn.heads import decode_csl_defer

    cfg = CONFIGS["yolov5l-csl"]
    ref, heads = _heads(cfg, 21)
    conf, iou = 0.3, 0.4
    dec = decode_csl_defer(heads, ref.anchors, STRIDES, cfg["nc"])
    dets, valid = post_process_defer(dec, heads, ref.na, cfg["nc"], conf, iou)
    dets, valid = dets.numpy(), valid.numpy()
    anchors = [torch.as_tensor(a) for a in ref.anchors]
    rows, cvalid, boxes = compare.candidates(heads, anchors, ref.na,
                                             cfg["nc"], conf)

    def faults(d, v):
        return compare.nms_faults(d, v, rows, cvalid, boxes, iou, 1500)
    assert valid.sum() > 10
    assert sum(faults(dets, valid).values()) == 0
    moved = dets.copy()
    moved[0, 0, 1] += 0.5
    assert faults(moved, valid)["rows_off"] == 1
    dropped = valid.copy()
    dropped[1, valid[1].sum() - 1] = False  # the last kept row of image 1
    assert faults(dets, dropped)["missed"] >= 1
    assert sum(faults(dets, np.zeros_like(valid)).values()) > 0
