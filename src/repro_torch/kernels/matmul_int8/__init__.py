from repro_torch.kernels.matmul_int8.ops import quantized_matmul
