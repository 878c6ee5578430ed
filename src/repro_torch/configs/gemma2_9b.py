"""Config alias for --arch gemma2-9b (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("gemma2-9b")
