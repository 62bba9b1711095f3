"""Training-curve plotter — a copy of ``paddle_tpu/trainer/plot.py`` (the
reference's python/paddle/v2/plot/plot.py:32 Ploter).

Collects (step, value) series per title and renders via matplotlib when
available (``plot.py`` falls back to text in non-notebook contexts; here the
fallback is a no-op draw with the data still query-able for tests/tools).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class Ploter:
    def __init__(self, *titles: str):
        self.titles = list(titles)
        self.data: Dict[str, Tuple[List[float], List[float]]] = {
            t: ([], []) for t in titles}

    def append(self, title: str, step: float, value: float):
        xs, ys = self.data[title]
        xs.append(step)
        ys.append(value)

    def reset(self):
        for t in self.titles:
            self.data[t] = ([], [])

    def plot(self, path: str = None):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        fig, ax = plt.subplots()
        for t in self.titles:
            xs, ys = self.data[t]
            ax.plot(xs, ys, label=t)
        ax.set_xlabel("step")
        ax.legend()
        if path:
            fig.savefig(path)
        plt.close(fig)
        return path
