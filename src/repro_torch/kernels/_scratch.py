"""Scratch memory of the kernels whose blocks meet in a second pass of the
same launch (the split flash decode, cost_reduce cut into slices): the
blocks' partial results, and one arrival counter (a ticket) per output tile.

One pair of buffers per (device, stream), grown as needed and shared by
every such kernel queued on that stream: a launch writes and reads its
partial results within itself and leaves every counter it used at 0, so
launches ordered on one stream never see each other's scratch."""
from __future__ import annotations

import torch

_store: dict = {}               # (device index, stream) -> (part, ticket)


def split_scratch(device: torch.device, stream: int, part_bytes: int,
                  n_ticket: int) -> tuple:
    """Addresses of ``part_bytes`` of partial results and of ``n_ticket``
    zeroed 32-bit counters on ``device`` for kernels on ``stream``."""
    key = (device.index, stream)
    part, ticket = _store.get(key, (None, None))
    if part is None or part.numel() < part_bytes:
        part = torch.empty(part_bytes, dtype=torch.uint8, device=device)
    if ticket is None or ticket.numel() < n_ticket:
        ticket = torch.zeros(n_ticket, dtype=torch.int32, device=device)
    _store[key] = (part, ticket)
    return part.data_ptr(), ticket.data_ptr()
