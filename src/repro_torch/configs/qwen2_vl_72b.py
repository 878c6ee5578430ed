"""Config alias for --arch qwen2-vl-72b (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("qwen2-vl-72b")
