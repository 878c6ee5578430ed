"""Config alias for --arch qwen3-4b (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("qwen3-4b")
