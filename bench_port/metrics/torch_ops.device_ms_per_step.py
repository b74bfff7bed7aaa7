"""Device ms a step of PyTorch's own operations between the kernels, the
ones that the torch_ops layer's pattern files (``layers/torch_ops.*.json``)
name: sorts, gathers, ``cat``, the integrator's elementwise ops, copies,
in the profiled solve."""

import core


def read(record: dict) -> float | None:
    s = core.layer_seconds(record, "torch_ops")
    return s * 1e3 / record["profile"]["steps"] if s else None
