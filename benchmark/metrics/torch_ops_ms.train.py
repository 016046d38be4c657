"""torch_ops_ms.train: device milliseconds per training step of the
kernels that PyTorch and its libraries launch (elementwise, reductions,
copies, fills, sorts, cuBLAS), told apart from the port's hand-written
kernels by these name patterns."""

PATTERNS = ("at::", "at_cuda_detail", "cub::", "gemm", "gemv", "cutlass",
            "xmma", "cublas", "splitK", "Memcpy", "Memset")


def is_torch_op(name: str) -> bool:
    return any(p in name for p in PATTERNS)


def read(w):
    if w.kind != "train" or w.steps == 0:
        return None
    seconds, launches = w.trace.kernel_s(is_torch_op)
    return 1e3 * seconds / w.steps if launches else None
