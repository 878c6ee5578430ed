"""Config alias for --arch deepseek-moe-16b (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("deepseek-moe-16b")
