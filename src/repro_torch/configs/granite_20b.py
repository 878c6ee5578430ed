"""Config alias for --arch granite-20b (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("granite-20b")
