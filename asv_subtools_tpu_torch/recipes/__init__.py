"""Recipes run through the port (``python -m asv_subtools_tpu_torch.recipes.<name>``)."""
