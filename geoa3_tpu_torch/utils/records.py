"""Research-record writers (the port's own copy of
geoa3_tpu/utils/records.py; reference Lib/utility.py:654-714).

Save the converged-iteration histogram and loss-vs-iteration curves as
.mat + .png. Plotting degrades gracefully if matplotlib is unavailable.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import scipy.io as sio


def _plt():
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class ConvergeIterRecorder:
    """Histogram of the iteration at which each attack converged
    (reference `Count_converge_iter`, utility.py:654-677)."""

    def __init__(self, fsave: str):
        self.fsave = fsave
        os.makedirs(fsave, exist_ok=True)
        self.attack_step_list: List[int] = []

    def record(self, attack_step_list: Sequence[int]) -> None:
        self.attack_step_list += [s for s in attack_step_list if s != -1]

    def save(self) -> None:
        sio.savemat(
            os.path.join(self.fsave, "converge_iter.mat"),
            {"attack_step_list": self.attack_step_list},
        )

    def plot(self) -> None:
        plt = _plt()
        if plt is None or not self.attack_step_list:
            return
        fig, ax = plt.subplots()
        ax.hist(self.attack_step_list, bins=20)
        ax.set_xlabel("Converged iteration")
        ax.set_ylabel("Number of Samples")
        fig.savefig(os.path.join(self.fsave, "converge_iter.png"))
        plt.close(fig)


class LossIterRecorder:
    """Loss-vs-iteration mean +- std curve
    (reference `Count_loss_iter`, utility.py:680-714)."""

    def __init__(self, fsave: str):
        self.fsave = fsave
        os.makedirs(fsave, exist_ok=True)
        self.loss_numpy: np.ndarray | None = None

    def record(self, loss_list) -> None:
        arr = np.asarray(loss_list)  # [steps, b]
        if self.loss_numpy is None:
            self.loss_numpy = arr
        else:
            self.loss_numpy = np.concatenate([self.loss_numpy, arr], axis=1)

    def save(self) -> None:
        sio.savemat(
            os.path.join(self.fsave, "loss_iter.mat"), {"loss": self.loss_numpy}
        )

    def plot(self) -> None:
        plt = _plt()
        if plt is None or self.loss_numpy is None:
            return
        num_iter, _ = self.loss_numpy.shape
        x = np.arange(1, num_iter + 1)
        mean = self.loss_numpy.mean(1)
        std = self.loss_numpy.std(1)
        fig, ax = plt.subplots()
        ax.plot(x, mean, color="r")
        ax.fill_between(x, mean - std, mean + std, color="r", alpha=0.2)
        ax.set_xlabel("Number of iteration")
        ax.set_ylabel("Magnitude of loss")
        fig.savefig(os.path.join(self.fsave, "loss_iter.png"))
        plt.close(fig)
