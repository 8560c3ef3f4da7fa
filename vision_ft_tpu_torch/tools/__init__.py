"""Command-line tools of the port (``python -m vision_ft_tpu_torch.tools.<name>``)."""
