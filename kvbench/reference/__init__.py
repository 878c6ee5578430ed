"""The plain reference the benchmark judges the port against: float32
PyTorch with TF32 off, importing nothing of the port.  Everything the
port derives (prompt ids, quantized KV, logits) is worked out again here
from the inputs the benchmark makes: the seed's weights, the prompt
keys, and the profile the controller chose."""
