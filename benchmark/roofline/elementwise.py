"""PyTorch's elementwise, reduction and fill kernels and copies: the
composed work around the kernels (BatchNorm in training, the losses'
arithmetic, the optimiser)."""
NAME, PATTERN, LAYER, PORT, ORDER = ("elementwise",
                                     r"(?i)elementwise|vectorized|unrolled|reduce|"
                                     r"memset|memcpy|fill|cat|copy|index|scatter|gather|sort",
                                     "torch", False, 6)


def bound_s(layout, rates):
    return None
