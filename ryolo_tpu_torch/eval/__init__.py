"""Post-processing (class-max, selection, deferred theta, rotated NMS),
the mAP metrics and the evaluator."""
