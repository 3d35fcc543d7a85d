"""Seeded weight initialisation on a device."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


class Init:
    """Draws f32 weights from ``generator`` on ``device``; every shape is
    prefixed by ``lead`` (the stacked ``n_periods`` axis of a period slot,
    each copy drawn on its own).  With ``store`` each weight is drawn on
    ``device`` and kept on ``store`` (the host), so ``device`` holds one
    weight at a time and the values are ``device``'s generator's."""

    def __init__(self, generator: torch.Generator, device,
                 lead: Tuple[int, ...] = (), store=None):
        self.generator, self.device, self.lead = generator, device, tuple(lead)
        self.store = device if store is None else store

    def stacked(self, n: int) -> "Init":
        return Init(self.generator, self.device, self.lead + (n,),
                    self.store)

    def _shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return self.lead + tuple(shape)

    def normal(self, shape: Sequence[int], std: float) -> torch.Tensor:
        x = torch.randn(self._shape(shape), generator=self.generator,
                        device=self.device, dtype=torch.float32)
        return x.mul_(std).to(self.store)

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(self._shape(shape), dtype=torch.float32,
                           device=self.store)

    def ones(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.ones(self._shape(shape), dtype=torch.float32,
                          device=self.store)

    def full(self, shape: Sequence[int], value: float) -> torch.Tensor:
        return torch.full(self._shape(shape), value, dtype=torch.float32,
                          device=self.store)

    def const(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` (f32), repeated over the lead dims."""
        v = values.to(device=self.store, dtype=torch.float32)
        return v.expand(self.lead + tuple(v.shape)).contiguous()
