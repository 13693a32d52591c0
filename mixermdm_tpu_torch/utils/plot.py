"""Visualisation: 3D skeleton animations + influence-weight plots; this
package's copy of ``mixermdm_tpu/utils/plot.py``.

Reference src/utils/plot.py: ``plot_3d_motion``:13 (matplotlib 3D skeleton
video over the HML kinematic chain) and the per-mixing-mode influence
visualisations ``plot_influence_{1..4}`` :134-352 (denoise-step x joint
weight surfaces, saved as PDF).  matplotlib is imported inside the
functions: rendering is best effort, and a machine without it samples all
the same (the inference CLI prints that it skipped the plots).
"""

from __future__ import annotations

import numpy as np

from .constants import HML_KINEMATIC_CHAIN, NUM_JOINTS

_COLORS = ["#DD5A37", "#D69E00", "#B75A39", "#DD5A37", "#D69E00"]
_COLORS_P2 = ["#4D84AA", "#5B9965", "#61CEB9", "#4D84AA", "#5B9965"]


def _extract_joints(motion: np.ndarray) -> list[np.ndarray]:
    """(T, 262) or (T, 524) feature vectors -> per-person (T, 22, 3)."""
    persons = []
    n_persons = motion.shape[-1] // 262
    for p in range(max(1, n_persons)):
        feats = motion[..., p * 262 : (p + 1) * 262]
        persons.append(feats[..., : NUM_JOINTS * 3].reshape(-1, NUM_JOINTS, 3))
    return persons


def plot_3d_motion(save_path: str, motion: np.ndarray, title: str = "",
                   fps: int = 30, radius: float = 2.0):
    """Render a skeleton animation to mp4/gif (plot.py:13-131)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    persons = _extract_joints(np.asarray(motion))
    T = persons[0].shape[0]

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")

    def update(frame):
        ax.clear()
        ax.set_title(title, fontsize=9)
        ax.set_xlim(-radius, radius)
        ax.set_ylim(0, radius)
        ax.set_zlim(-radius, radius)
        ax.view_init(elev=110, azim=-90)
        ax.axis("off")
        for pi, joints in enumerate(persons):
            colors = _COLORS if pi == 0 else _COLORS_P2
            j = joints[frame]
            for ci, chain in enumerate(HML_KINEMATIC_CHAIN):
                idx = list(chain)
                ax.plot3D(j[idx, 0], j[idx, 1], j[idx, 2],
                          linewidth=2.0, color=colors[ci % len(colors)])

    anim = FuncAnimation(fig, update, frames=T, interval=1000 / fps)
    try:
        anim.save(save_path, fps=fps)
    except (ValueError, RuntimeError):
        # No ffmpeg: fall back to an animated gif via Pillow.
        save_path = save_path.rsplit(".", 1)[0] + ".gif"
        anim.save(save_path, fps=fps, writer="pillow")
    plt.close(fig)
    return save_path


_INFL_CMAP_WARM = ["#8A033E", "#C44E30", "#FCC00B"]
_INFL_CMAP_COOL = ["#084E8C", "#A7BFBB", "#B3CE75"]


def influence_joint_weights(history: np.ndarray) -> np.ndarray:
    """Recover the 23 per-joint weights from an expanded (..., 262) history
    (reference plot.py:218-219, 265-266): every 3rd of the 66 position dims
    (the 22 joint weights repeat x3) plus dim 192 (the contact weight as the
    reference reads it back)."""
    history = np.asarray(history)
    return np.concatenate(
        [history[..., :66:3], history[..., 192:193]], axis=-1
    )


def influence_surfaces(history: np.ndarray, mode: int):
    """The exact arrays the reference plots per mode (plot.py:134-352).

    ``history``: (S, B, T, 262) stacked per-denoise-step expanded weights.
    Returns a dict of named 1-D/2-D arrays (sample 0, as upstream).
    """
    h = np.asarray(history)
    if h.ndim == 3:          # (S, T, 262) — single sample
        h = h[:, None]
    if mode == 1:
        return {"line": h[:, 0, 0, 0]}                       # (S,)
    if mode == 2:
        return {"step_x_time": h[:, 0, :, 0]}                # (S, T)
    h23 = influence_joint_weights(h)
    if mode == 3:
        return {"step_x_joint": h23[:, 0, 0, :]}             # (S, 23)
    if mode == 4:
        return {
            "step_x_time": h23[:, 0, :, :].mean(axis=-1),    # (S, T)
            "step_x_joint": h23[:, 0, :, :].mean(axis=-2),   # (S, 23)
        }
    raise ValueError(f"unknown mixing mode {mode}")


def _surface_pdf(pdf, X, Y, Z, ylabel, cmap_colors, y_ticks_max):
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap
    from matplotlib.ticker import FormatStrFormatter

    cmap = LinearSegmentedColormap.from_list("custom_cmap", cmap_colors)
    fig = plt.figure(figsize=(18, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_box_aspect([1.5, 1.5, 0.9])
    ax.plot_surface(X, Y, Z, cmap=cmap, edgecolor="none")
    max_val = max(float(Z.max()), 1e-6)
    ax.set_xlabel("Denoising Step", fontsize=14, labelpad=10)
    ax.set_ylabel(ylabel, fontsize=14, labelpad=10)
    ax.set_zlim(0, max_val)
    ax.zaxis.set_ticks(np.linspace(0, max_val, 3))
    ax.zaxis.set_major_formatter(FormatStrFormatter("%.2f"))
    ax.xaxis.set_ticks(np.linspace(0, Z.shape[0], 4).astype(int))
    ax.yaxis.set_ticks(np.linspace(0, y_ticks_max, 5).astype(int))
    ax.tick_params(axis="both", which="major", labelsize=14)
    pdf.savefig(fig)
    plt.close(fig)


def plot_influence(save_path: str, influence: np.ndarray, mixing_mode: int = 4,
                   influence2: np.ndarray | None = None):
    """Influence PDFs matching the reference per mode (plot.py:134-363).

    ``influence``: (S, B, T, 262) person-1 expanded-weight history (or
    (S, T, 262)); mode 1 draws the gradient-coloured line, mode 2 the
    step x timestep surface, mode 3 the step x joint surface, mode 4 BOTH
    the joint-mean step x timestep and the time-mean step x joint surfaces.
    Writes ``{save_path}_influence{mode}.pdf``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.colors import LinearSegmentedColormap, Normalize

    base = save_path.rsplit(".", 1)[0] if save_path.endswith(".pdf") else save_path
    out_path = f"{base}_influence{mixing_mode}.pdf"
    surfaces = influence_surfaces(influence, mixing_mode)

    with PdfPages(out_path) as pdf:
        if mixing_mode == 1:
            line = surfaces["line"]
            cmap = LinearSegmentedColormap.from_list("custom_cmap", _INFL_CMAP_WARM)
            norm = Normalize(vmin=float(line.min()), vmax=float(line.max()) or 1.0)
            fig, ax = plt.subplots(figsize=(6, 5))
            for i in range(len(line) - 1):
                ax.plot([i, i + 1], line[i : i + 2],
                        color=cmap(norm(line[i])), linewidth=3)
            ax.set_xlabel("Denoising Step", fontsize=15, labelpad=10)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)
        elif mixing_mode == 2:
            Z = surfaces["step_x_time"]
            X, Y = np.meshgrid(np.arange(Z.shape[0]), np.arange(Z.shape[1]),
                               indexing="ij")
            _surface_pdf(pdf, X, Y, Z, "Timestep", _INFL_CMAP_WARM, 300)
        elif mixing_mode == 3:
            Z = surfaces["step_x_joint"]
            X, Y = np.meshgrid(np.arange(Z.shape[0]), np.arange(Z.shape[1]),
                               indexing="ij")
            _surface_pdf(pdf, X, Y, Z, "Joint", _INFL_CMAP_COOL, 23)
        else:
            Zt = surfaces["step_x_time"]
            Xt, Yt = np.meshgrid(np.arange(Zt.shape[0]), np.arange(Zt.shape[1]),
                                 indexing="ij")
            _surface_pdf(pdf, Xt, Yt, Zt, "Timestep", _INFL_CMAP_WARM, 300)
            Zj = surfaces["step_x_joint"]
            Xj, Yj = np.meshgrid(np.arange(Zj.shape[0]), np.arange(Zj.shape[1]),
                                 indexing="ij")
            _surface_pdf(pdf, Xj, Yj, Zj, "Joint", _INFL_CMAP_WARM, 23)
    return out_path
