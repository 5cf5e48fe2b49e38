"""Device ms a step in kernels that are neither products (cuBLAS, CUTLASS)
nor the port's ``csrc/`` kernels: elementwise passes, copies, reductions."""


def read(record):
    tr, steps = record.readings.get("trace"), record.readings.get("traced_steps")
    if not tr or not steps:
        return None
    return 1e3 * tr["by_class"].get("elementwise", 0.0) / steps
