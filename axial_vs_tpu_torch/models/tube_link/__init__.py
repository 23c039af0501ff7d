"""Tube-Link (Mask2Former tube head) video instance segmentation."""
