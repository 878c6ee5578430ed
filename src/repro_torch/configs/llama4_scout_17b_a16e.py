"""Config alias for --arch llama4-scout-17b-a16e (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("llama4-scout-17b-a16e")
