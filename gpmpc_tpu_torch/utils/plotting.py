"""matplotlib on demand for the port's figures (``MPC.plot``,
``Model.plot_compare`` and the examples' own).

matplotlib is imported when a figure is drawn, never when the port is
imported: a machine without it runs every controller and loses only the
figures.  There :func:`pyplot` raises :class:`MatplotlibMissing`, the one
exception the examples catch around their plotting."""

from __future__ import annotations


class MatplotlibMissing(ImportError):
    """matplotlib is not installed, so no figure can be drawn."""


def pyplot():
    """``matplotlib.pyplot`` on the file-only Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise MatplotlibMissing(
            "drawing a figure needs matplotlib, which is not installed") \
            from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt
