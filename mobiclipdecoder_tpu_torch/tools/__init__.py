"""Deployment tools of the port (``python -m mobiclipdecoder_tpu_torch.tools.<name>``)."""
