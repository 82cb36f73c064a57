"""Shared set-up for the parity tests of the PyTorch port (tests/test_torch_*.py).

Builds the JAX reference model (YOLOv4, v5 or v7, CSL or KFIoU head) with every
parameter and BN statistic jittered from a numpy seed (as
tests/test_deploy.py:25-50 does, so the deploy folds are not trivial), and
the port's model carrying the same weights through
``state_dict_from_flax``.
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


def jax_model(ver: str, seed: int = 0, mode: str = "csl"):
    """``(model, variables)``: the JAX ``ver`` model with the ``mode`` head,
    jittered numpy weights (:func:`random_variables`)."""
    from ryolo_tpu.nn import Yolo

    model = Yolo(n_classes=NC, model_config=MODEL_CFG, mode=mode, ver=ver)
    return model, random_variables(model, np.zeros((1, 64, 64, 3),
                                                   np.float32), seed)


def random_variables(module, x, seed: int):
    """Variables of the flax ``module`` drawn by numpy, then jittered:
    kernels ~ N(0, 1/fan_in) (flax's LeCun scale), biases 0, BN scale 1
    and statistics (0, 1), implicit priors as the blocks draw them.  Only
    the shapes come from flax (``jax.eval_shape``: a trace, no init run,
    which takes 10-16 s for a whole model on the CPU)."""
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf, shape = path[-1].key, s.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if leaf == "implicit":
            mean = 1.0 if path[-2].key.startswith("im") else 0.0
            return rng.normal(mean, 0.02, shape).astype(np.float32)
        fill = 1.0 if leaf in ("scale", "var") else 0.0
        return np.full(shape, fill, np.float32)

    return jitter_variables(jax.tree_util.tree_map_with_path(draw, shapes),
                            seed)


def jitter_variables(variables, seed: int):
    """Every parameter jittered; BN means shifted, variances redrawn."""
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
    return {"params": params, "batch_stats": stats}


def jax_v7(seed: int = 0):
    """``(model, variables)``: the JAX v7-CSL model, initialised by flax,
    jittered numpy weights."""
    from ryolo_tpu.nn import Yolo

    model = Yolo(n_classes=NC, model_config=MODEL_CFG, mode="csl",
                 ver="yolov7")
    init = jax.jit(lambda k, x: model.init(k, x, train=False))
    variables = jax.device_get(init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 64, 64, 3))))
    return model, jitter_variables(variables, seed)


def jax_ver(ver: str, seed: int = 0, mode: str = "csl"):
    """``jax_v7`` for yolov7-CSL (the weights its tests were measured on),
    :func:`jax_model` for the others."""
    if ver == "yolov7" and mode == "csl":
        return jax_v7(seed)
    return jax_model(ver, seed, mode)


def ver_mode(param: str):
    """``"yolov5"`` -> ``("yolov5", "csl")``; ``"yolov5-kfiou"`` ->
    ``("yolov5", "kfiou")``."""
    ver, _, mode = param.partition("-")
    return ver, mode or "csl"


def torch_model(variables, ver: str, mode: str = "csl"):
    """The port's train-structure ``ver`` model with the ``mode`` head and
    the JAX weights, eval."""
    from ryolo_tpu_torch.nn import Yolo
    from ryolo_tpu_torch.utils.checkpoint import state_dict_from_flax

    model = Yolo(NC, MODEL_CFG, mode=mode, ver=ver)
    model.load_state_dict(state_dict_from_flax(variables, ver), strict=True)
    return model.eval()


def torch_v7(variables):
    """The port's train-structure v7-CSL model with the JAX weights, eval."""
    return torch_model(variables, "yolov7")


def nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))
