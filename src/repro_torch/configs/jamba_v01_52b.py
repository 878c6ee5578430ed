"""Config alias for --arch jamba-v0.1-52b (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("jamba-v0.1-52b")
