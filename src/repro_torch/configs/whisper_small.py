"""Config alias for --arch whisper-small (see repro_torch/configs/archs.py)."""
from repro_torch.configs import get_config

CONFIG = get_config("whisper-small")
