"""Config alias for --arch deepseek-v2-lite (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("deepseek-v2-lite")
