"""The benchmark's plain reference: the rotated YOLO model with its CSL head,
the CSL loss, the tap renderer, the decode and post-process with the plain
rotated IoU and NMS, in plain PyTorch.

Every module here is a frozen copy of the port's plain code at commit
d329eff (each says which file), cut where it reached into the port's
kernels, sharding or deploy forms, plus the benchmark's own comparisons
(:mod:`.compare`) and tile bank (:mod:`.bank`).  Nothing here imports
``ryolo_tpu_torch``, ``ryolo_tpu`` or JAX, and nothing takes a tensor that
the port derived: the harness hands both sides the same seeded weights,
files and loader batches, and this package works out again the tile bank,
the rendered images, the unfused model's forward, the loss, the update and
the candidates.  Run it in float32 with TF32 off
(:func:`.compare.float32_math`).
"""
