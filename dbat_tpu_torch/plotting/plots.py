"""Visualization layer (ref code/plotting/*.m), matplotlib backend (a
copy of dbat_tpu/plotting/plots.py on the port's modules).

All functions return a matplotlib Figure and accept `save=path` for
non-interactive use.  Families mirror the reference:
  plot_network     -- 3D network + camera icons + optional iteration
                      playback of the solver trace (plotnetwork.m)
  plot_params      -- IO/EO/OP + damping parameter iteration traces
                      (plotparams.m)
  plot_image_stats -- per-image coverage/point count/residuals/std
                      (plotimagestats.m)
  plot_op_stats    -- per-OP ray count/residual/std (plotopstats.m)
  plot_coverage    -- measurement coverage per image (plotcoverage.m)
  plot_images      -- measurements over an image (plotimages.m)

Host numpy and matplotlib (imported at the first figure); the
statistics panels build the port's Covariance, which runs on the
device of the bundle's ops.
"""

from __future__ import annotations

import numpy as np


def _fig(title):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 7))
    fig.suptitle(title)
    return fig, plt


def _camera_icon(ax, C, R, size, color="b"):
    """Simple pyramid camera glyph (ref code/plotting/cameraicon.m).

    R is world-to-camera; the camera looks along -z (DBAT convention)."""
    w = size
    d = size * 1.5
    corners = np.array(
        [[-w, -w, -d], [w, -w, -d], [w, w, -d], [-w, w, -d]]
    )
    world = C + corners @ R  # R.T @ corner per row
    for k in range(4):
        a, b = world[k], world[(k + 1) % 4]
        ax.plot(*np.stack([a, b]).T, color=color, lw=0.6)
        ax.plot(*np.stack([C, world[k]]).T, color=color, lw=0.6)


def _iteration_state(project, info, iteration):
    """(eo, op) at a given solver iteration (deserialize replay of the
    trace column; ref code/misc/deserialize.m:8-20)."""
    import torch

    from ..core.serial import deserialize

    x = torch.as_tensor(info.trace[:, iteration], dtype=torch.float64)
    _io, eo_, op_ = deserialize(info.spec, x, *(
        torch.as_tensor(a, dtype=torch.float64)
        for a in (project.io, project.eo, project.op)))
    return eo_.numpy(), op_.numpy()


def _align_transform(project, eo, align):
    """4x4 transform putting camera `align` at the origin with its own
    axes (plotnetwork.m 'align' option)."""
    from ..models.rotation import w2c_from_angles_np

    i = int(align)
    R = w2c_from_angles_np(eo[i, 3:6])[0]
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ eo[i, 0:3]
    return T


def _draw_network(ax, p, eo, op, cam_size, T=None):
    from ..models.rotation import w2c_from_angles_np

    if T is not None:
        ok = ~np.isnan(op).any(axis=1)
        op = op.copy()
        op[ok] = (T[:3, :3] @ op[ok].T + T[:3, 3:4]).T
    est = ~np.isnan(op).any(axis=1)
    ctrl = p.is_ctrl
    ax.scatter(*op[est & ~ctrl].T, s=2, c="k", marker=".", label="OP")
    if (est & ctrl).any():
        ax.scatter(*op[est & ctrl].T, s=30, c="r", marker="^", label="CP")
    for i in range(p.n_img):
        if np.isnan(eo[i]).any():
            continue
        R = w2c_from_angles_np(eo[i, 3:6])[0]
        C = eo[i, 0:3]
        if T is not None:
            R = R @ T[:3, :3].T
            C = T[:3, :3] @ C + T[:3, 3]
        _camera_icon(ax, C, R, cam_size)


def plot_network(project, info=None, title="Camera network",
                 cam_size=0.1, iteration=None, save=None, align=None):
    """3D network plot; with `info` and `iteration`, shows the solver
    trace state at that iteration (deserialize replay,
    ref plotnetwork.m + code/misc/deserialize.m).  `align`: camera
    index defining the origin/axes (plotnetwork.m 'align')."""
    p = project
    eo, op = p.eo, p.op
    if info is not None and iteration is not None:
        eo, op = _iteration_state(p, info, iteration)

    fig, plt = _fig(title)
    ax = fig.add_subplot(111, projection="3d")
    T = _align_transform(p, eo, align) if align is not None else None
    _draw_network(ax, p, eo, op, cam_size, T)
    ax.legend(loc="upper right", fontsize=8)
    if save:
        fig.savefig(save, dpi=120)
        plt.close(fig)
    return fig


def plot_network_playback(project, info, save, title="Iteration %d/%d",
                          cam_size=0.1, align=None, fps: int = 2):
    """Animated iteration playback of the solver trace: camera-center
    trace lines accumulate, object points re-plot per iteration
    (plotnetwork.m E-trace playback, 'pause'/'title' semantics).

    `save` ends in .gif (PillowWriter) or a %d-pattern for PNG frames.
    Returns the number of frames written."""
    p = project
    n_iter = info.trace.shape[1]
    states = [_iteration_state(p, info, k) for k in range(n_iter)]

    fig, plt = _fig("")
    ax = fig.add_subplot(111, projection="3d")

    def draw(k):
        ax.clear()
        eo, op = states[k]
        T = _align_transform(p, eo, align) if align is not None else None
        _draw_network(ax, p, eo, op, cam_size, T)
        # Camera-center trace lines up to iteration k.
        for i in range(p.n_img):
            Cs = np.stack([states[m][0][i, 0:3] for m in range(k + 1)])
            if np.isnan(Cs).any():
                continue
            if T is not None:
                Cs = (T[:3, :3] @ Cs.T + T[:3, 3:4]).T
            ax.plot(*Cs.T, color="g", lw=0.5)
        ax.set_title(title % ((k, n_iter - 1) if title.count("%d") == 2
                              else (k,)))

    if str(save).endswith(".gif"):
        from matplotlib.animation import FuncAnimation, PillowWriter

        anim = FuncAnimation(fig, draw, frames=n_iter)
        anim.save(save, writer=PillowWriter(fps=fps))
    else:
        for k in range(n_iter):
            draw(k)
            fig.savefig(str(save) % k, dpi=100)
    plt.close(fig)
    return n_iter


def plot_params(project, info, save=None):
    """Iteration traces of IO/EO/OP parameters and damping values
    (ref plotparams.m).  IO traces are split per parameter family and
    labeled with their names (cc/px/py/... from info.param_types); EO
    positions and angles get separate panels; the damping panel shows
    the accepted step sizes (alpha / lambda / delta / rho)."""
    p = project
    spec = info.spec
    T = info.trace  # (n_x, n_iter+1)
    names = list(getattr(info, "param_types", []) or [])
    fig, plt = _fig("Parameter iteration traces")
    n_io, n_eo = spec.n_io, spec.n_eo
    n_panels = (2 if n_io else 0) + (2 if n_eo else 0) + 2
    fig.set_size_inches(9, 1.9 * n_panels)
    axs = fig.subplots(n_panels, 1, sharex=True)
    it = np.arange(T.shape[1])
    k = 0

    def io_name(i):
        return names[i].split(":")[-1] if i < len(names) else str(i)

    if n_io:
        # Linear params (cc/px/py/aspect/skew) and lens coefficients
        # get separate panels — their scales differ by orders.
        lin = [i for i in range(n_io)
               if not io_name(i)[:1] in ("K", "P")]
        lens = [i for i in range(n_io) if i not in lin]
        for grp, lbl in ((lin, "IO linear"), (lens, "IO lens K/P")):
            for i in grp:
                axs[k].plot(it, T[i], lw=0.9, label=io_name(i))
            axs[k].set_ylabel(lbl)
            if grp and len(grp) <= 10:
                axs[k].legend(fontsize=6, ncol=5)
            k += 1
    if n_eo:
        eox = np.asarray(spec.eo_x)
        pos = [int(v) for v in eox[:, 0:3].reshape(-1) if v >= 0]
        ang = [int(v) for v in eox[:, 3:6].reshape(-1) if v >= 0]
        axs[k].plot(it, T[pos].T, lw=0.5)
        axs[k].set_ylabel("EO position")
        k += 1
        axs[k].plot(it, T[ang].T * 180.0 / np.pi, lw=0.5)
        axs[k].set_ylabel("EO angles (deg)")
        k += 1
    n_show = min(300, T.shape[0] - n_io - n_eo)
    if n_show > 0:
        axs[k].plot(it, T[n_io + n_eo:n_io + n_eo + n_show].T, lw=0.3)
        axs[k].set_ylabel("OP (subset)")
    k += 1
    d = info.damping
    if d.get("name") == "gna" and d.get("alphas"):
        axs[k].semilogy(np.arange(1, len(d["alphas"]) + 1), d["alphas"],
                        "o-", label="alpha")
    elif d.get("name") == "lm" and d.get("lambdas"):
        axs[k].semilogy(np.maximum(d["lambdas"], 1e-300), "o-",
                        label="lambda")
    elif d.get("name") == "lmp":
        if d.get("deltas"):
            axs[k].semilogy(d["deltas"], "o-", label="delta")
        if d.get("rhos"):
            ax2 = axs[k].twinx()
            ax2.plot(d["rhos"], "x--", color="tab:red", lw=0.7)
            ax2.set_ylabel("rho", color="tab:red")
    axs[k].set_ylabel("damping")
    axs[k].legend(fontsize=7)
    axs[k].set_xlabel("iteration")
    if save:
        fig.savefig(save, dpi=120)
        plt.close(fig)
    return fig


def plot_image_stats(project, info=None, save=None):
    """Per-image statistic panels (ref plotimagestats.m): coverage
    (rectangular + convex hull), point count, camera ray angles,
    RMS residuals with the global RMS line, and — with `info` —
    spatial X/Y/Z/total and angular omega/phi/kappa/total posterior
    standard deviations per camera station."""
    from ..geometry.quality import coverage
    from ..io.stats import cam_angles
    from ..solve.quality import residual_stats

    p = project
    n_panels = 4 + (2 if info is not None else 0)
    fig, plt = _fig("Image statistics")
    fig.set_size_inches(9, 1.9 * n_panels)
    axs = fig.subplots(n_panels, 1, sharex=True)
    idx = np.arange(1, p.n_img + 1)

    axs[0].bar(idx - 0.2, coverage(p) * 100, width=0.4, label="rect")
    axs[0].bar(idx + 0.2, coverage(p, convex_hull=True) * 100,
               width=0.4, label="hull")
    axs[0].set_ylabel("coverage %")
    axs[0].legend(fontsize=7)

    axs[1].bar(idx, np.bincount(p.obs_img, minlength=p.n_img))
    axs[1].set_ylabel("# points")

    ang = cam_angles(p) * 180.0 / np.pi
    axs[2].bar(idx, ang)
    axs[2].set_ylabel("ray angle (deg)")

    if p.post is not None:
        rs = residual_stats(p)
        axs[3].bar(idx, rs["photo_rms"])
        glob = np.sqrt(np.mean(
            np.sum(p.post["ip_res_px"] ** 2, axis=1) / 2))
        axs[3].axhline(glob, ls="--", color="k", lw=0.8)
        axs[3].set_ylabel("RMS px")

    if info is not None:
        from ..solve.covariance import Covariance

        cov = Covariance(p, info).factorize()
        _, std_eo, _ = cov.posterior_std()
        for k, lbl in enumerate(("X", "Y", "Z")):
            axs[4].bar(idx + 0.2 * (k - 1), std_eo[:, k], width=0.2,
                       label=lbl)
        axs[4].plot(idx, np.sqrt(np.nansum(std_eo[:, :3] ** 2, axis=1)),
                    "k.", label="total")
        axs[4].set_ylabel("pos std")
        axs[4].legend(fontsize=7, ncol=4)
        for k, lbl in enumerate(("om", "ph", "ka")):
            axs[5].bar(idx + 0.2 * (k - 1),
                       std_eo[:, 3 + k] * 180.0 / np.pi, width=0.2,
                       label=lbl)
        axs[5].plot(idx, np.sqrt(np.nansum(
            (std_eo[:, 3:6] * 180.0 / np.pi) ** 2, axis=1)), "k.",
            label="total")
        axs[5].set_ylabel("ang std (deg)")
        axs[5].legend(fontsize=7, ncol=4)

    axs[-1].set_xlabel("image")
    if save:
        fig.savefig(save, dpi=120)
        plt.close(fig)
    return fig


def plot_op_stats(project, info=None, max_op=1000, save=None):
    """Per-OP ray count, residual, std (ref plotopstats.m)."""
    from ..geometry.quality import ray_counts
    from ..solve.quality import residual_stats

    p = project
    fig, plt = _fig("Object point statistics")
    axs = fig.subplots(3, 1, sharex=True)
    sel = np.arange(min(p.n_op, max_op))
    axs[0].bar(sel, ray_counts(p)[sel])
    axs[0].set_ylabel("rays")
    if p.post is not None:
        rs = residual_stats(p)
        axs[1].bar(sel, rs["point_rms"][sel])
        axs[1].set_ylabel("RMS px")
    if info is not None:
        from ..solve.covariance import Covariance

        cov = Covariance(p, info).factorize()
        _, _, std_op = cov.posterior_std()
        axs[2].bar(sel, np.nansum(std_op[sel] ** 2, axis=1) ** 0.5)
        axs[2].set_ylabel("std")
    axs[2].set_xlabel("OP index")
    if save:
        fig.savefig(save, dpi=120)
        plt.close(fig)
    return fig


def plot_coverage(project, convex_hull=True, save=None):
    """Measurement footprints over the image format
    (ref plotcoverage.m)."""
    p = project
    fig, plt = _fig("Coverage")
    ax = fig.add_subplot(111)
    w, h = p.sensor_im_size[0]
    ax.add_patch(plt.Rectangle((0, 0), w, h, fill=False, ec="k"))
    cmap = plt.get_cmap("tab20")
    for i in range(p.n_img):
        pts = p.ip_px[p.obs_img == i]
        if len(pts) < 3:
            continue
        if convex_hull:
            try:
                from scipy.spatial import ConvexHull

                hull = ConvexHull(pts)
                poly = pts[hull.vertices]
                ax.fill(poly[:, 0], poly[:, 1], alpha=0.1,
                        color=cmap(i % 20))
            except Exception:
                pass
        ax.plot(pts[:, 0], pts[:, 1], ".", ms=1, color=cmap(i % 20))
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    ax.set_aspect("equal")
    if save:
        fig.savefig(save, dpi=120)
        plt.close(fig)
    return fig


def plot_images(project, image_no=0, save=None):
    """Measurements over one image (ref plotimages.m); draws the image
    file when available."""
    p = project
    fig, plt = _fig(f"Image {image_no + 1}: {p.img_labels[image_no]}")
    ax = fig.add_subplot(111)
    import os.path as osp

    name = p.img_names[image_no]
    if name and osp.exists(name):
        try:
            img = plt.imread(name)
            ax.imshow(img)
        except Exception:
            pass
    sel = p.obs_img == image_no
    ctrl = p.is_ctrl[p.obs_pt[sel]]
    pts = p.ip_px[sel]
    ax.plot(pts[~ctrl, 0], pts[~ctrl, 1], "rx", ms=4)
    ax.plot(pts[ctrl, 0], pts[ctrl, 1], "^", color="y", mec="k", ms=8)
    w, h = p.sensor_im_size[image_no]
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    if save:
        fig.savefig(save, dpi=120)
        plt.close(fig)
    return fig
