"""Visualization (counterpart of ``paddlescience_tpu/visualize``): the
``Visualizer`` base and ``VisualizerRadar``'s frame strips. The other
writers are not ported yet."""

from paddlescience_torch.visualize.visualizer import Visualizer, VisualizerRadar

__all__ = ["Visualizer", "VisualizerRadar"]
