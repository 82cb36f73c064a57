"""Port checkpoint bridge: JAX tree -> reference-ordered state_dict, for
YOLOv7, v5 and v4 with the CSL head and YOLOv7 and v5 with the KFIoU head
(the same names; only the head convs' shapes differ).

``ryolo_tpu_torch.utils.checkpoint.state_dict_from_flax`` must equal the
JAX package's ``export_state_dict`` tensor by tensor, and the port's model
must take it with ``load_state_dict(strict=True)`` in the reference order.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import jax_ver, limit_threads, ver_mode

VERS = ["yolov7", "yolov5", "yolov4"]


@pytest.fixture(scope="module", params=VERS + ["yolov7-kfiou",
                                               "yolov5-kfiou"])
def jax_variables(request):
    """``(variables, ver, mode)``."""
    limit_threads()
    ver, mode = ver_mode(request.param)
    return jax_ver(ver, seed=3, mode=mode)[1], ver, mode


def test_state_dict_from_flax_equals_export(jax_variables):
    from ryolo_tpu.utils.checkpoint import export_state_dict
    from ryolo_tpu_torch.utils.checkpoint import state_dict_from_flax

    variables, ver, _ = jax_variables
    want = export_state_dict(variables, ver)
    got = state_dict_from_flax(variables, ver)
    assert list(got.keys()) == list(want.keys())
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("ver", VERS)
def test_layout_matches_jax_layout(ver):
    from ryolo_tpu.utils.checkpoint import state_dict_layout as jax_layout
    from ryolo_tpu_torch.utils.checkpoint import state_dict_layout

    assert state_dict_layout(ver) == jax_layout(ver)


def test_load_state_dict_strict_in_reference_order(jax_variables):
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.utils.checkpoint import (state_dict_from_flax,
                                                  state_dict_layout)
    from tests.torch_parity import MODEL_CFG, NC

    variables, ver, mode = jax_variables
    model = Yolo(NC, MODEL_CFG, mode=mode, ver=ver)
    sd = state_dict_from_flax(variables, ver)
    model.load_state_dict(sd, strict=True)
    # the last level's head conv: 3 x (185 + nc) or 18 x (6 + nc) outputs
    head = {"yolov7": "neck.conv7", "yolov5": "neck.conv19",
            "yolov4": "neck.conv38"}[ver] + ".conv.0.bias"
    assert sd[head].shape == ((3 * (185 + NC),) if mode == "csl"
                              else (18 * (6 + NC),))
    # the port's registration order is the reference .pth order
    assert list(model.state_dict().keys()) == \
        [n for n, _ in state_dict_layout(ver)]
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name


def test_load_pth_roundtrip(jax_variables, tmp_path):
    from ryolo_tpu.utils.checkpoint import save_pth
    from ryolo_tpu_torch.utils.checkpoint import (load_pth,
                                                  state_dict_from_flax)

    variables, ver, mode = jax_variables
    path = tmp_path / "w.pth"
    save_pth(variables, ver, str(path))
    got = load_pth(str(path))
    want = state_dict_from_flax(variables, ver)
    assert list(got.keys()) == list(want.keys())
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_bottleneck_names_map_to_the_jax_lists():
    """``m.K`` (an ``nn.Sequential`` of bottlenecks) is the JAX tree's
    ``m_K``, as the JAX package's own ``torch_name_to_flax`` maps it, for
    every entry of every layout."""
    from ryolo_tpu.utils.checkpoint import torch_name_to_flax as jax_map
    from ryolo_tpu_torch.utils.checkpoint import (state_dict_layout,
                                                  torch_name_to_flax)

    n_lists = 0
    for ver in VERS:
        for name, _ in state_dict_layout(ver):
            assert torch_name_to_flax(name) == jax_map(name), name
            n_lists += ".m." in name
    assert torch_name_to_flax("backbone.csp3.m.11.cv2.conv.1.running_var") \
        == ("batch_stats", ("backbone", "csp3", "m_11", "cv2", "bn", "var"),
            None)
    assert n_lists > 500
