"""Config alias for --arch falcon-mamba-7b (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("falcon-mamba-7b")
