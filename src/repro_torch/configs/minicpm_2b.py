"""Config alias for --arch minicpm-2b (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("minicpm-2b")
