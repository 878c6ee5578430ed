from repro_torch.data.synthetic import WORKLOADS, WorkloadSpec, make_batch, make_prompt
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["WORKLOADS", "WorkloadSpec", "make_batch", "make_prompt", "ByteTokenizer"]
