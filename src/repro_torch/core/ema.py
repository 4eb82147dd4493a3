"""Teacher EMA:  w~ <- gamma * w~ + (1 - gamma) * w   (Section III step (1),
Eq. (8) second line for client-side teacher bottoms), computed in fp32."""
from __future__ import annotations

from repro_torch.tree import tree_map


def ema_update(teacher, student, gamma: float):
    return tree_map(
        lambda t, s: (gamma * t.float() + (1.0 - gamma) * s.float()
                      ).to(t.dtype),
        teacher, student)
