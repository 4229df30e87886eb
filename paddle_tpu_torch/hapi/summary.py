"""Model summary and forward FLOPs (the counterpart of
``paddle_tpu/hapi/summary.py``).

:func:`summary` runs one forward of zeros through the network in eval
mode with a forward hook on every leaf module and prints the JAX
package's table: each leaf's name, type, first output's shape and own
parameter count, then the totals.  :func:`flops` counts the forward's
operations with ``torch.utils.flop_counter.FlopCounterMode`` (products:
``2 * M * K * N`` a matmul), where the JAX package asks XLA's cost
analysis of the compiled forward.
"""
from __future__ import annotations

import torch

__all__ = ["summary", "flops"]


def _device(net):
    for p in net.parameters():
        return p.device
    return torch.device("cpu")


def _zeros(net, input_size):
    sizes = input_size if isinstance(input_size, list) and isinstance(
        input_size[0], (list, tuple)) else [input_size]
    x = [torch.zeros([s if s is not None else 1 for s in size],
                     dtype=torch.float32, device=_device(net))
         for size in sizes]
    return x[0] if len(x) == 1 else x


def summary(net: torch.nn.Module, input_size=None, dtypes=None, input=None):
    """Print a table of ``net``'s leaf modules on one forward of zeros of
    ``input_size`` (or of ``input``); returns ``{"total_params",
    "trainable_params"}``."""
    rows = []
    hooks = []

    def register(layer, name):
        def hook(m, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            shape = list(out.shape) if isinstance(out, torch.Tensor) \
                else "?"
            n_params = sum(p.numel() for p in m.parameters(recurse=False))
            rows.append((name or type(m).__name__, type(m).__name__,
                         shape, n_params))
        hooks.append(layer.register_forward_hook(hook))

    for name, sub in net.named_modules():
        if sub is not net and not any(True for _ in sub.children()):
            register(sub, name)

    if input is not None:
        x = input
    else:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        x = _zeros(net, input_size)

    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(x) if not isinstance(x, list) else net(*x)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    header = f"{'Layer':<40}{'Type':<24}{'Output Shape':<24}{'Params':>12}"
    print(header)
    print("-" * len(header))
    for name, typ, shape, n in rows:
        print(f"{name:<40}{typ:<24}{str(shape):<24}{n:>12,}")
    print("-" * len(header))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    return {"total_params": total, "trainable_params": trainable}


def flops(net: torch.nn.Module, input_size, custom_ops=None,
          print_detail=False):
    """The operations of one forward of zeros of ``input_size`` in eval
    mode, as ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode
    x = _zeros(net, input_size)
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            net(x) if not isinstance(x, list) else net(*x)
    finally:
        if was_training:
            net.train()
    total = int(counter.get_total_flops())
    if print_detail:
        print(f"Total FLOPs: {total:,}")
    return total
