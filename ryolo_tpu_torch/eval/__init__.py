"""Post-processing: class-max, selection, deferred theta, rotated NMS."""
