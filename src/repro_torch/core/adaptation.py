"""Global updating frequency adaptation (Section IV-B, Alg. 1 lines 22-23):
a copy of the JAX package's ``core/adaptation.py`` (pure Python).

  * per round h it receives the mean supervised loss f_s^h and the mean
    semi-supervised loss f_u^h,
  * observation periods of ``observation_period`` rounds produce period
    means; the indicator I_n = 1 iff the unsupervised loss declines faster
    (Eq. (9)),
  * R_h = mean of I_n over the last ``adaptation_window`` periods; when
    R_h >= 0.5, K_s <- max(floor(K_s / alpha), K_min)   (Eq. (10)),
    with K_min = floor(beta * |D_l| / |D| * K_u).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs import SemiSFLConfig


@dataclass
class FreqController:
    cfg: SemiSFLConfig
    n_labeled: int
    n_total: int
    k_s: int = 0
    _fs_acc: list = field(default_factory=list)
    _fu_acc: list = field(default_factory=list)
    _period_fs: list = field(default_factory=list)
    _period_fu: list = field(default_factory=list)
    _indicators: list = field(default_factory=list)
    history: list = field(default_factory=list)

    def __post_init__(self):
        if self.k_s == 0:
            self.k_s = self.cfg.k_s_init

    @property
    def k_min(self) -> int:
        frac = self.n_labeled / max(self.n_total, 1)
        return max(1, int(self.cfg.beta * frac * self.cfg.k_u))

    @property
    def r_h(self) -> float:
        w = self._indicators[-self.cfg.adaptation_window:]
        if not w:
            return 0.0
        return sum(w) / len(w)

    def update(self, f_s: float, f_u: float) -> int:
        """Feed round-h losses; returns K_s^{h+1}."""
        self._fs_acc.append(float(f_s))
        self._fu_acc.append(float(f_u))
        if len(self._fs_acc) >= self.cfg.observation_period:
            self._period_fs.append(sum(self._fs_acc) / len(self._fs_acc))
            self._period_fu.append(sum(self._fu_acc) / len(self._fu_acc))
            self._fs_acc, self._fu_acc = [], []
            if len(self._period_fs) >= 2:
                d_fs = self._period_fs[-2] - self._period_fs[-1]
                d_fu = self._period_fu[-2] - self._period_fu[-1]
                self._indicators.append(1 if d_fu > d_fs else 0)
                if (len(self._indicators) >= self.cfg.adaptation_window
                        and self.r_h >= 0.5):
                    self.k_s = max(int(self.k_s / self.cfg.alpha), self.k_min)
                    self._indicators.clear()
        self.history.append(self.k_s)
        return self.k_s

    def state_dict(self) -> dict:
        return {"k_s": self.k_s, "indicators": list(self._indicators),
                "period_fs": list(self._period_fs),
                "period_fu": list(self._period_fu),
                "fs_acc": list(self._fs_acc), "fu_acc": list(self._fu_acc)}

