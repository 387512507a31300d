"""The repository's examples (``examples/``) through the port; run each
as ``python -m abpoa_tpu_torch.examples.<name> [--device cpu]``."""
