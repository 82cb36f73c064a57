"""Port checkpoint bridge: JAX tree -> reference-ordered state_dict.

``ryolo_tpu_torch.utils.checkpoint.state_dict_from_flax`` must equal the
JAX package's ``export_state_dict`` tensor by tensor, and the port's model
must take it with ``load_state_dict(strict=True)`` in the reference order.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import jax_v7, limit_threads


@pytest.fixture(scope="module")
def jax_variables():
    limit_threads()
    return jax_v7(seed=3)[1]


def test_state_dict_from_flax_equals_export(jax_variables):
    from ryolo_tpu.utils.checkpoint import export_state_dict
    from ryolo_tpu_torch.utils.checkpoint import state_dict_from_flax

    want = export_state_dict(jax_variables, "yolov7")
    got = state_dict_from_flax(jax_variables, "yolov7")
    assert list(got.keys()) == list(want.keys())
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)


def test_layout_matches_jax_layout():
    from ryolo_tpu.utils.checkpoint import state_dict_layout as jax_layout
    from ryolo_tpu_torch.utils.checkpoint import state_dict_layout

    assert state_dict_layout("yolov7") == jax_layout("yolov7")


def test_load_state_dict_strict_in_reference_order(jax_variables):
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.utils.checkpoint import (state_dict_from_flax,
                                                  state_dict_layout)
    from tests.torch_parity import MODEL_CFG, NC

    model = Yolo(NC, MODEL_CFG, mode="csl", ver="yolov7")
    sd = state_dict_from_flax(jax_variables, "yolov7")
    model.load_state_dict(sd, strict=True)
    # the port's registration order is the reference .pth order
    assert list(model.state_dict().keys()) == \
        [n for n, _ in state_dict_layout("yolov7")]
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name


def test_load_pth_roundtrip(jax_variables, tmp_path):
    from ryolo_tpu.utils.checkpoint import save_pth
    from ryolo_tpu_torch.utils.checkpoint import (load_pth,
                                                  state_dict_from_flax)

    path = tmp_path / "w.pth"
    save_pth(jax_variables, "yolov7", str(path))
    got = load_pth(str(path))
    want = state_dict_from_flax(jax_variables, "yolov7")
    assert list(got.keys()) == list(want.keys())
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("ver", ["yolov4", "yolov5"])
def test_unported_layouts_raise(ver):
    from ryolo_tpu_torch.utils.checkpoint import state_dict_layout

    with pytest.raises(NotImplementedError, match="A2"):
        state_dict_layout(ver)
