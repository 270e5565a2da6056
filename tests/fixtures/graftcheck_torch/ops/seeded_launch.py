"""graftcheck fixture: the torch host-sync rule on a kernel's tick path.

NOT imported by anything — parsed by tests/test_torch_analysis.py.
``launch`` is a root (it calls a ``tpuraft_*`` entry point of the
library ``load()`` returns); ``wrapper`` reaches it from the tick plane
(``ops/``); ``_helper`` is reached through the root.  ``ok_host_probe``
uses every banned construct but is on no tick path.
"""

import torch


def load():
    return None


def _helper(t: torch.Tensor):
    return t.tolist()                 # VIOLATION: reached through a root


def launch(match: torch.Tensor, out: torch.Tensor, n: int):
    lib = load()
    if match.dim() != 2 or not match.is_contiguous():   # clean: metadata
        raise ValueError("bad plane")
    if match.dtype != torch.int32 or match.device != out.device:  # clean
        raise TypeError("bad dtype")
    if n > 4:                         # clean: scalar parameter
        n = 4
    rc = lib.tpuraft_seeded(match.data_ptr(), out.data_ptr(), n)
    if rc != 0:                       # clean: the entry point's int code
        raise RuntimeError(rc)
    peak = match.max().item()         # VIOLATION: .item()
    head = int(match[0, 0])           # VIOLATION: int() of a tensor
    _helper(out)
    return peak, head


def wrapper(match, out=None):
    if out is None:                   # clean: identity, not values
        out = torch.empty(match.shape[0], dtype=torch.int32)
    total = torch.zeros(1)
    if total.sum() > 0:               # VIOLATION: data-dependent `if`
        total = total + 1
    while bool(out.any()):            # VIOLATION x2: `while` and bool()
        break
    launch(match, out, 3)
    host = out.cpu()                  # VIOLATION: .cpu()
    scale = float(total)              # VIOLATION: float() of a tensor
    # graftcheck: allow(host-sync) — fixture: the tick's one D2H copy
    return host.numpy(), scale


def ok_host_probe(t):
    arr = t.cpu().numpy()
    if t.sum() > 0:
        return int(t[0]), t.item(), arr.tolist()
    return 0, None, None
