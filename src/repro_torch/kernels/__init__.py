"""CoDec decode-attention kernels: CUDA PAC and POR, their plain torch
versions, the plan arrays and the backend registry."""
