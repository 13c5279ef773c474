"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet,
dense rates without sparsity, at the full 700 W power limit)."""

TF32_TENSOR_OPS_S = 495e12      # float32 operands on the tensor cores
FP32_CUDA_CORE_OPS_S = 67e12    # float32 outside the tensor cores
HBM_BYTES_S = 3.35e12

TF32_NAME = "495 TFLOP/s TF32 dense (tensor cores)"
FP32_NAME = "67 TFLOP/s float32 (CUDA cores)"
HBM_NAME = "3.35 TB/s HBM3"


def least_seconds(ops: float, n_bytes: float, peak_ops: float):
    """(seconds, bound): the larger of operations over the peak rate and
    bytes over the memory bandwidth, and which of the two it is."""
    t_ops, t_bytes = ops / peak_ops, n_bytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
