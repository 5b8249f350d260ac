"""Matrix products of cuBLAS and CUTLASS (the victims' dense layers)."""
NAME, PATTERN, LAYER, PORT, ORDER = ("matmul", r"(?i)gemm|sgemm|xmma|cutlass|cublas",
                                     "victim", False, 5)


def bound_s(layout, rates):
    return None
