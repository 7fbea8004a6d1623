"""On-device ops: the normalize kernel and the augmentation around it."""
