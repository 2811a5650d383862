"""How the request paths compare the program's outputs with the reference's."""

from __future__ import annotations

import torch


def nan_max(a: float, b: float) -> float:
    """max(a, b), NaN if either is: a reading that is NaN must fail its check."""
    return float("nan") if a != a or b != b else max(a, b)


class Gaps:
    """`<name>_rel_rms` of each output name: ||got - ref|| / ||ref|| over
    every checked image of it together, in float64."""

    def __init__(self):
        self.err2, self.ref2 = {}, {}

    def add(self, name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
        got, ref = got.double(), ref.double()
        self.err2[name] = self.err2.get(name, 0.0) + float((got - ref).square().sum())
        self.ref2[name] = self.ref2.get(name, 0.0) + float(ref.square().sum())

    def readings(self) -> dict:
        return {f"{n}_rel_rms": (e / max(self.ref2[n], 1e-300)) ** 0.5
                for n, e in self.err2.items()}
