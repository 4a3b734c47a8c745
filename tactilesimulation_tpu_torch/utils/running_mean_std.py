"""Running mean / variance of observations (parallel Welford update).

Port of ``tactilesimulation_tpu/utils/running_mean_std.py``: a value type
whose ``update`` returns a new instance.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(shape, dtype=torch.float32, device="cpu", epsilon=1e-4):
        return RunningMeanStd(mean=torch.zeros(shape, dtype=dtype,
                                               device=device),
                              var=torch.ones(shape, dtype=dtype,
                                             device=device),
                              count=torch.tensor(epsilon, dtype=dtype,
                                                 device=device))

    def update(self, batch) -> "RunningMeanStd":
        """batch: (N, *shape)."""
        bmean = torch.mean(batch, dim=0)
        bvar = torch.var(batch, dim=0, unbiased=False)
        bcount = batch.shape[0]
        delta = bmean - self.mean
        tot = self.count + bcount
        new_mean = self.mean + delta * bcount / tot
        m_a = self.var * self.count
        m_b = bvar * bcount
        M2 = m_a + m_b + delta ** 2 * self.count * bcount / tot
        return RunningMeanStd(mean=new_mean, var=M2 / tot, count=tot)

    def normalize(self, x, un_norm=False):
        if un_norm:
            return x * torch.sqrt(self.var + 1e-5) + self.mean
        return (x - self.mean) / torch.sqrt(self.var + 1e-5)

    def state_dict(self):
        return {"mean": self.mean, "var": self.var, "count": self.count}

    @staticmethod
    def from_state_dict(d) -> "RunningMeanStd":
        return RunningMeanStd(mean=d["mean"], var=d["var"], count=d["count"])
