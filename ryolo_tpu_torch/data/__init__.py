"""Host data (datasets, render specs, the spec loader) and device-side
augmentation."""
