"""Row 13: the C-channel scatter (scatter_nc_rows), the unfused train
route's gather backward; no bound is stated for it here."""
NAME, PATTERN, LAYER, PORT, ORDER = "scatter_nc", r"scatter_nc_rows", "victim", True, 0


def bound_s(layout, rates):
    return None
