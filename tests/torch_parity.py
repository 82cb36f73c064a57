"""Shared set-up for the parity tests of the PyTorch port (tests/test_torch_*.py).

Builds the JAX reference YOLOv7-CSL with every parameter and BN statistic
jittered from a numpy seed (as tests/test_deploy.py:25-50 does, so the
deploy folds are not trivial), and the port's model carrying the same
weights through ``state_dict_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

MODEL_CFG = {
    "anchors": [[12, 16, 19, 36, 40, 28], [36, 75, 76, 55, 72, 146],
                [142, 110, 192, 243, 459, 401]],
    "angles": [-90, -60, -30, 0, 30, 60],
}
NC = 2


def limit_threads():
    # several pytest-xdist workers share the host's cores
    torch.set_num_threads(2)


def jax_v7(seed: int = 0):
    """``(model, variables)``: the JAX v7-CSL model, jittered numpy weights."""
    from ryolo_tpu.nn import Yolo

    model = Yolo(n_classes=NC, model_config=MODEL_CFG, mode="csl",
                 ver="yolov7")
    init = jax.jit(lambda k, x: model.init(k, x, train=False))
    variables = jax.device_get(init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(seed)

    def jitter(a):
        a = np.asarray(a)
        return a + rng.normal(0, 0.1 * a.std() + 0.01,
                              a.shape).astype(a.dtype)

    def jitter_stats(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return np.abs(rng.normal(1.0, 0.3, a.shape)).astype(a.dtype) + 0.2
        return a + rng.normal(0, 0.2, a.shape).astype(a.dtype)

    params = jax.tree_util.tree_map(jitter, variables["params"])
    stats = jax.tree_util.tree_map_with_path(jitter_stats,
                                             variables["batch_stats"])
    return model, {"params": params, "batch_stats": stats}


def torch_v7(variables):
    """The port's train-structure v7-CSL model with the JAX weights, eval."""
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.utils.checkpoint import state_dict_from_flax

    model = Yolo(NC, MODEL_CFG, mode="csl", ver="yolov7")
    model.load_state_dict(state_dict_from_flax(variables, "yolov7"),
                          strict=True)
    return model.eval()


def nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))
