"""Bundle result report generator (ref code/bundle/bundle_result_file.m;
counterpart of dbat_tpu/io/report.py, which it follows line for line).

Reproduces the reference's report structure section by section so
reports diff cleanly against shipped DBAT exports:

  Project / Problems and suggestions / Information from last bundle /
  Lens distortion models / Cameras (calibrated values ± deviations,
  significance, correlations) / Precisions / Quality (photographs,
  cameras, coverage, point measurements, residuals, precision, angles,
  ctrl/check measurements).
"""

from __future__ import annotations

import time
import uuid as uuid_mod

import numpy as np

from ..models.residuals import N_LIN


def _fmt(v, digits=6):
    if v is None or (isinstance(v, float) and not np.isfinite(v)):
        return "-"
    return f"{v:.{digits}g}"


IO_PARAM_NAMES = ["cc", "px", "py", "as", "sk"]
IO_PARAM_DESC = {
    "cc": "Camera Constant",
    "px": "px - principal point x",
    "py": "py - principal point y",
    "as": "as - off-unit aspect parameter",
    "sk": "sk - skew",
}


def write_report(project, info, path, damping="gna", conv_tol=1e-6,
                 abs_term=False, singular_test=True, veto=False,
                 corr_threshold=0.95, sig_threshold=0.95):
    """Write a DBAT-style result file; returns collected stats dict."""
    from ..geometry.quality import (
        coverage,
        point_angles,
        radial_coverage,
        ray_counts,
    )
    from ..solve.covariance import Covariance
    from ..solve.quality import (
        high_correlations,
        high_eo_correlations,
        high_io_correlations_cross,
        high_point_correlations,
        residual_stats,
        significance,
    )

    p = project
    # Per-stage covariance timings (bundle_result_file.m:268-279 prints
    # prep/CIO/CEO/COP separately).
    t0 = time.time()
    cov = Covariance(p, info).factorize()
    t_prep = time.time() - t0
    t0 = time.time()
    cio = cov.cio()
    try:
        ciof, io_entries = cov.ciof()
        corr_io_cross = high_io_correlations_cross(
            ciof, io_entries, corr_threshold)
    except Exception:
        corr_io_cross = []
    t_cio = time.time() - t0
    t0 = time.time()
    ceo = cov.ceo()
    corr_eo = high_eo_correlations(ceo, p.eo_block, corr_threshold)
    t_ceo = time.time() - t0
    t0 = time.time()
    cop = cov.cop()
    t_cop = time.time() - t0
    std_io, std_eo, std_op = cov.posterior_std()

    sig = significance(p, info.spec, cio)
    corr_io = high_correlations(cio, corr_threshold)
    hi_op = high_point_correlations(cop, corr_threshold)
    # Low-significance check (bundle_result_file.m:156-183): any
    # estimated distortion/affine coefficient below sigThreshold.
    sig_vals = np.concatenate(
        [sig["K"].reshape(-1), sig["P"].reshape(-1), sig["B"].reshape(-1)])
    low_sig = bool(np.any(sig_vals[np.isfinite(sig_vals)] < sig_threshold))
    rstats = residual_stats(p)
    angles = point_angles(p)
    rays = ray_counts(p)

    code_names = {
        0: "OK",
        -1: "Too many iterations",
        -2: "Normal matrix singular",
        -3: "Line search failed",
        -4: "Structurally rank deficient Jacobian",
    }

    L = []
    add = L.append
    add("Damped Bundle Adjustment Toolbox result file")
    add("   Project")
    add(f"      Name             : {p.title}")
    add(f"      Computation UUID : {uuid_mod.uuid4()}")
    add(f"      Input file name  : {p.file_name}")
    if p.cpt_file:
        add(f"      Ctrl pt file     : {p.cpt_file}")
    if p.eo_file:
        add(f"      EO file          : {p.eo_file}")

    # Problems section (bundle_result_file.m:57-184).
    add("   Problems and suggestions:")
    add("      Project Problems:")
    ws = info.weakness.get("structural")
    wn = info.weakness.get("numerical")
    if ws is None:
        add("         Structural rank: ok.")
    else:
        add(f"         Structural rank: {ws['rank']} "
            f"(deficiency: {ws['deficiency']})")
        add("            DMPERM suggests the following parameters "
            "have problems:")
        for k in np.asarray(ws["suspected_params"]):
            nm = info.param_types[k] if info.param_types else str(k)
            add(f"               {nm}")
    if wn is None or not wn.get("deficiency"):
        add("         Numerical rank: ok.")
    elif not np.isfinite(wn.get("rank", np.nan)):
        add("         Numerical rank: not tested.")
    else:
        add(f"         Numerical rank: {wn['rank']} "
            f"(deficiency: {wn['deficiency']})")
        add("            Null-space suggest the following parameters "
            "are part of the problem:")
        for vi, sp in enumerate(wn.get("suspected_params", [])):
            add(f"               Vector {vi+1} (eigenvalue {sp['eig']:g}):")
            for k, v in zip(sp["indices"], sp["values"]):
                nm = info.param_types[k] if info.param_types else str(k)
                add(f"                  ({nm}, {v:.3g})")
    problems = []
    suggestions = []
    if info.code != 0:
        problems.append(
            f"Bundle failed with code {info.code} (see below for details)."
        )
    if corr_io or corr_io_cross:
        problems.append(
            "One or more of the camera parameter has a high correlation "
            "(see below)."
        )
        suggestions.append(
            "Consider fixing or constraining the correlated camera "
            "parameters, or adding oblique/rolled images to decorrelate "
            "them."
        )
    if corr_eo:
        problems.append(
            "One or more of the camera station parameters has a high "
            "correlation (see below)."
        )
        suggestions.append(
            "High station correlations usually indicate a weak network "
            "geometry; consider more convergent imagery or prior EO "
            "observations."
        )
    if len(hi_op):
        problems.append(
            "One or more of the object point coordinates has a high "
            "correlation."
        )
        suggestions.append(
            "Points with highly correlated coordinates have few or "
            "narrow-angle rays; consider a ray-count/angle filter "
            "(check_ray_count / angle filtering)."
        )
    if low_sig:
        problems.append(
            "One or more estimated lens and/or affine distortion "
            "coefficients failed significance test (see below)."
        )
        suggestions.append(
            "Consider fixing insignificant distortion coefficients at "
            "zero (set_bundle_estimate_params)."
        )
    add(f"      Problems related to the processing: ({len(problems)})")
    for s in problems:
        add(f"         {s}")
    if suggestions:
        add("      Suggestions:")
        for s in suggestions:
            add(f"         {s}")

    # Bundle info (bundle_result_file.m:185-256).
    from .. import __version__

    add("   Information from last bundle")
    add(f"      Last Bundle Run:        {time.strftime('%d-%b-%Y %H:%M:%S')}")
    add(f"      DBAT-TPU version:       {__version__}")
    add(f"      Status:                 {code_names.get(info.code, info.code)}")
    add(f"      Sigma0:                 {info.sigma0:.5g}")
    add(f"      Sigma0 (pixels):        {info.sigmas[0]:.5g}")
    add(f"      Redundancy              {info.redundancy}")
    n_prior = info.spec.n_prior
    add(f"      Number of params:       {info.num_params} "
        f"({info.spec.n_io} IO, {info.spec.n_eo} EO, {info.spec.n_op} OP)")
    n_ip = 2 * info.ops.n_obs
    add(f"      Number of observations: {info.num_obs} "
        f"({n_ip} IP, {len(info.spec.io_obs_x)} IO, "
        f"{len(info.spec.eo_obs_x)} EO, {len(info.spec.op_obs_x)} OP)")
    add("      Processing options:")
    add(f"         Orientation:             on")
    add(f"         Global optimization:     on")
    add(f"         Calibration:             "
        f"{'on' if p.est_io.any() else 'off'}")
    add(f"         Constraints:             off")
    add(f"         Maximum # of iterations: 20")
    add(f"         Convergence tolerance:   {conv_tol:g}")
    add(f"         Termination criteria:    "
        f"{'absolute' if abs_term else 'relative'}")
    add(f"         Singular test:           "
        f"{'on' if singular_test else 'off'}")
    add(f"         Chirality veto:          {'on' if veto else 'off'}")
    add(f"         Damping:                 {damping}")
    add(f"         Camera unit (cu):        {p.cam_unit}")
    add(f"         Object space unit (ou):  {p.obj_unit}")
    add(f"         Initial value comment:   {p.x0desc}")
    add("      Total error:")
    add(f"         Number of stages:     1")
    add(f"         Number of iterations: {info.used_iters}")
    if info.res_norms:
        add(f"         First error:          {info.res_norms[0]:.6g}")
        add(f"         Last error:           {info.res_norms[-1]:.6g}")
    add("      Execution times (s):")
    add(f"         Bundle:        {info.time:.2f}")
    add(f"         Post-cov prep: {t_prep:.2f}")
    add(f"         Post-cov CIO:  {t_cio:.2f}")
    add(f"         Post-cov CEO:  {t_ceo:.2f}")
    add(f"         Post-cov COP:  {t_cop:.2f}")

    add("      Lens distortion models:")
    model = p.dist_model
    kind = "Backward (Photogrammetry)" if model > 0 else "Forward (Computer Vision)"
    add(f"         {kind} model {abs(model)}")

    # Cameras (bundle_result_file.m:292-460). PM sign convention for
    # display: py, K, P negated (DBATCamera.m:59-80).
    add("      Cameras:")
    est_any = p.est_io.any(axis=0)
    names = IO_PARAM_NAMES + [f"K{i+1}" for i in range(p.nK)] + [
        f"P{i+1}" for i in range(p.nP)
    ]
    cal_params = " ".join(n for n, e in zip(names, est_any) if e)
    add(f"         Calibration: {'yes (' + cal_params + ')' if est_any.any() else 'no'}")
    cross = [(a, b, v) for (a, b, v) in corr_io_cross if a[0] != b[0]]
    if cross:
        add(f"         Cross-camera correlations over "
            f"{corr_threshold*100:g}%:")
        for (ia, ca), (ib, cb), v in cross:
            add(f"            Camera{ia+1}.{names[ca]} - "
                f"Camera{ib+1}.{names[cb]}: {v*100:.1f}%")
    lead = info.spec.io_leading.any(axis=1)
    cam_nos = np.flatnonzero(lead) if lead.any() else [0]
    for ci, j in enumerate(cam_nos):
        add(f"         Camera{ci+1} (simple)")
        add(f"            Lens distortion model:")
        add(f"               {kind} model {abs(model)}")

        def param_line(desc, val, dev, unit="", extra=()):
            add(f"            {desc}:")
            add(f"               Value:        {val:.6g} {unit}".rstrip())
            if dev is not None and np.isfinite(dev):
                add(f"               Deviation:    {dev:.3g} {unit}".rstrip())
            for e in extra:
                add(f"               {e}")

        io = p.io[j]
        # display with PM sign conventions
        disp = [io[0], io[1], -io[2], io[3], io[4]]
        for k, nm in enumerate(IO_PARAM_NAMES[:3]):
            param_line(IO_PARAM_DESC[nm], disp[k], std_io[j, k], "mm")
        # Sensor format (bundle_result_file.m camera block order:
        # cc/px/py, format, K, P, as/sk, image size, resolutions).
        # True physical sizes: the solver's sensor_px_size uses the y
        # pixel size for both axes (the x/y difference lives in the
        # 'as' parameter), but the report prints the real sensor.
        if p.sensor_ss_size is not None:
            fmt_w, fmt_h = p.sensor_ss_size[j]
        else:
            fmt_w = p.sensor_im_size[j, 0] * p.sensor_px_size[j, 0]
            fmt_h = p.sensor_im_size[j, 1] * p.sensor_px_size[j, 1]
        px_w = fmt_w / p.sensor_im_size[j, 0]
        px_h = fmt_h / p.sensor_im_size[j, 1]
        param_line("Format width", fmt_w, None, "mm")
        param_line("Format height", fmt_h, None, "mm")
        for i in range(p.nK):
            ii = N_LIN + i
            extra = []
            if np.isfinite(sig["K"][j, i]):
                extra.append(f"Significance: p={sig['K'][j,i]:.2f}")
            if np.isfinite(sig["KC"][j, i]):
                extra.append(f"Cumulative significance:p={sig['KC'][j,i]:.2f}")
            cors = [
                f"{names[b]}:{v*100:.1f}%"
                for (cj, a, b, v) in corr_io
                if cj == j and a == ii
            ] + [
                f"{names[a]}:{v*100:.1f}%"
                for (cj, a, b, v) in corr_io
                if cj == j and b == ii
            ]
            if cors:
                extra.append("Correlations over 95%: " + ", ".join(cors) + ".")
            param_line(f"K{i+1} - radial distortion {i+1}", -io[ii],
                       std_io[j, ii], f"mm^(-{3+2*i})", extra)
        for i in range(p.nP):
            ii = N_LIN + p.nK + i
            extra = []
            if i == 0 and np.isfinite(sig["P"][j]):
                extra.append(f"Significance: p={sig['P'][j]:.2f}")
            param_line(f"P{i+1} - decentering distortion {i+1}", -io[ii],
                       std_io[j, ii], "mm^(-3)", extra)
        for k, nm in ((3, "as"), (4, "sk")):
            extra = []
            if nm == "as" and np.isfinite(sig["B"][j, 0]):
                extra.append(f"Significance: p={sig['B'][j,0]:.2f}")
            if nm == "sk" and np.isfinite(sig["B"][j, 1]):
                extra.append(f"Significance: p={sig['B'][j,1]:.2f}")
            param_line(IO_PARAM_DESC[nm], disp[k], std_io[j, k], "",
                       extra)
        add(f"            Image width:")
        add(f"               Value:        {p.sensor_im_size[j,0]:.0f} px")
        add(f"            Image height:")
        add(f"               Value:        {p.sensor_im_size[j,1]:.0f} px")
        add(f"            X resolution:")
        add(f"               Value:        {1.0 / px_w:.6g} px/mm")
        add(f"            Y resolution:")
        add(f"               Value:        {1.0 / px_h:.6g} px/mm")
        add(f"            Pixel width:")
        add(f"               Value:        {px_w:.6g} mm")
        add(f"            Pixel height:")
        add(f"               Value:        {px_h:.6g} mm")
        # Rated angle of view + largest corner distortion
        # (bundle_result_file.m:436-459).
        whd = np.array([fmt_w, fmt_h, np.hypot(fmt_w, fmt_h)])
        aov = 2 * np.arctan(whd / (2 * io[0])) * 180 / np.pi
        add(f"         Rated angle of view (h,v,d): ({aov[0]:.0f}, "
            f"{aov[1]:.0f}, {aov[2]:.0f}) deg")
        xx = np.array([0.5, p.sensor_im_size[j, 0] + 0.5])
        yy = np.array([0.5, p.sensor_im_size[j, 1] + 0.5])
        cx = np.array([xx[0], xx[0], xx[1], xx[1]])
        cy = np.array([yy[0], yy[1], yy[1], yy[0]])
        # Internal-sign frame (display negates py/K/P; the corner
        # radii and the distortion magnitude are sign-invariant).
        # Corner positions in mm through the solver's px->mm factor
        # (both axes the collapsed y size, like the reference's
        # pxSize after prob2dbatstruct.m:247).
        xr = cx * p.sensor_px_size[j, 0] - io[1]
        yr = cy * p.sensor_px_size[j, 1] + io[2]
        r2 = xr**2 + yr**2
        K = io[N_LIN:N_LIN + p.nK]
        rad = sum(K[i] * r2 ** (i + 1) for i in range(p.nK))
        P1 = io[N_LIN + p.nK] if p.nP > 0 else 0.0
        P2 = io[N_LIN + p.nK + 1] if p.nP > 1 else 0.0
        # Deliberately reproduces the REFERENCE's formula including
        # its nonstandard cross terms (bundle_result_file.m:447-450
        # uses 2*P1*x*y in x and 2*P2*x*y in y; standard Brown — and
        # this repo's own models/primitives.py — has 2*P2 in x and
        # 2*P1 in y).  This line is a display statistic diffed
        # against reports generated WITH that formula; the actual
        # projection model is unaffected.
        xc = xr * rad + P1 * (r2 + 2 * xr**2) + 2 * P1 * xr * yr
        yc = yr * rad + P2 * (r2 + 2 * yr**2) + 2 * P2 * xr * yr
        mx_d = float(np.max(np.abs(xc) + np.abs(yc)))
        half_d = whd[2] / 2
        # px conversion uses the solver's (y-collapsed) pixel size:
        # the reference divides by pxSize(1,i), which prob2dbatstruct
        # sets to the y size for both axes (prob2dbatstruct.m:243-247).
        add(f"         Largest distortion: {mx_d:.2g} mm "
            f"({mx_d / p.sensor_px_size[j, 0]:.1f} px, "
            f"{mx_d / half_d * 100:.1f}% of half-diagonal)")

    # Precisions (bundle_result_file.m:461-514), with per-photo EO
    # correlation warnings (:483-509).
    eo_names = ["Xc", "Yc", "Zc", "Omega", "Phi", "Kappa"]
    eo_corr_of = {}
    for (k, a, b, v) in corr_eo:
        eo_corr_of.setdefault((k, a), []).append((b, v))
        eo_corr_of.setdefault((k, b), []).append((a, v))
    add("      Precisions / Standard Deviations:")
    add("         Photograph Standard Deviations:")
    deg = 180 / np.pi
    for i in range(p.n_img):
        add(f"            Photo {i+1}: {p.img_labels[i]}")
        for nm, k, scale, unit in (
            ("Omega", 3, deg, "deg"), ("Phi", 4, deg, "deg"),
            ("Kappa", 5, deg, "deg"), ("Xc", 0, 1, "ou"),
            ("Yc", 1, 1, "ou"), ("Zc", 2, 1, "ou"),
        ):
            add(f"               {nm}:")
            add(f"                  Value:     {p.eo[i,k]*scale:.6f} {unit}")
            if np.isfinite(std_eo[i, k]):
                add(f"                  Deviation: {std_eo[i,k]*scale:.3g} {unit}")
            others = eo_corr_of.get((i, k))
            if others:
                ss = ", ".join(f"{eo_names[b]}:{v*100:.1f}%"
                               for b, v in others)
                add(f"                  Correlations over "
                    f"{corr_threshold*100:g}%: {ss}.")

    # Quality (bundle_result_file.m:515-965).
    add("   Quality")
    add("      Photographs")
    add(f"         Total number: {p.n_img}")
    used = np.unique(p.obs_img)
    add(f"         Numbers used: {len(used)}")
    add("      Cameras")
    add(f"         Total number: {len(cam_nos)} ({len(cam_nos)} simple, "
        f"0 mixed)")
    # Per-camera quality block with union coverage
    # (bundle_result_file.m:524-554).  Cameras are identified by the
    # leading image of each distinct IO block; photos of a camera are
    # the images sharing its block.
    io_block = np.asarray(p.io_block) if p.io_block is not None else None
    for ci, j in enumerate(cam_nos):
        add(f"         Camera{ci+1}:")
        add(f"            Calibration:                   "
            f"{'yes' if p.est_io[j].any() else '<not available>'}")
        if io_block is not None:
            cams_of = np.flatnonzero(
                (io_block == io_block[j]).all(axis=1))
        else:
            cams_of = np.arange(p.n_img)
        add(f"            Number of photos using camera: {len(cams_of)}")
        rect = coverage(p, cams_of)
        ch = coverage(p, cams_of, convex_hull=True)
        rad = radial_coverage(p, cams_of)
        u_rect = coverage(p, cams_of, union=True)[0]
        u_ch = coverage(p, cams_of, convex_hull=True, union=True)[0]
        u_rad = radial_coverage(p, cams_of, union=True)[0]
        add("            Photo point coverage:")
        add(f"               Rectangular: {rect.min()*100:.0f}%-"
            f"{rect.max()*100:.0f}% ({rect.mean()*100:.0f}% average, "
            f"{u_rect*100:.0f}% union)")
        add(f"               Convex hull: {ch.min()*100:.0f}%-"
            f"{ch.max()*100:.0f}% ({ch.mean()*100:.0f}% average, "
            f"{u_ch*100:.0f}% union)")
        add(f"               Radial:      {rad.min()*100:.0f}%-"
            f"{rad.max()*100:.0f}% ({rad.mean()*100:.0f}% average, "
            f"{u_rad*100:.0f}% union)")
    add("      Photo Coverage")
    add("         Reference points outside calibrated region:")
    for ci, j in enumerate(cam_nos):
        add(f"            Camera {ci+1}: "
            f"{'none' if p.est_io[j].any() else '<not available>'}")

    add("      Point Measurements")
    n_cp = int(p.is_ctrl.sum())
    n_ccp = int(p.is_check.sum())
    n_op_only = p.n_op - n_cp - n_ccp
    add(f"         Number of control pts: {n_cp}")
    add(f"         Number of check pts: {n_ccp}")
    add(f"         Number of object pts: {n_op_only}")

    def ray_summary(mask, name):
        rr = rays[mask]
        if len(rr) == 0:
            add(f"         {name} ray count: -")
            return
        add(f"         {name} ray count: {rr.min()}-{rr.max()} "
            f"({rr.mean():.1f} avg)")
        for v in np.unique(rr):
            add(f"            {int((rr==v).sum())} points with {v} rays.")

    ray_summary(p.is_ctrl, "CP")
    ray_summary(p.is_check, "CCP")
    ray_summary(~p.is_ctrl & ~p.is_check, "OP")

    add("      Point Marking Residuals")
    add(f"         Overall point RMS: {rstats['overall_rms']:.3f} pixels")
    mx, mid, mph = rstats["mark_max"]
    add("         Mark point residuals:")
    add(f"            Maximum: {mx:.3f} pixels (OP {mid} on photo {mph})")
    prms = rstats["point_rms"]
    ok = np.isfinite(prms) & (rstats["point_count"] > 0)
    if ok.any():
        jmin = np.flatnonzero(ok)[np.argmin(prms[ok])]
        jmax = np.flatnonzero(ok)[np.argmax(prms[ok])]
        add("         Object point residuals (RMS over all images of a point):")
        add(f"            Minimum: {prms[jmin]:.3f} pixels (OP {p.op_id[jmin]} "
            f"over {int(rstats['point_count'][jmin])} images)")
        add(f"            Maximum: {prms[jmax]:.3f} pixels (OP {p.op_id[jmax]} "
            f"over {int(rstats['point_count'][jmax])} images)")
    phr = rstats["photo_rms"]
    okp = np.isfinite(phr) & (rstats["photo_count"] > 0)
    if okp.any():
        imin = np.flatnonzero(okp)[np.argmin(phr[okp])]
        imax = np.flatnonzero(okp)[np.argmax(phr[okp])]
        add("         Photo residuals (RMS over all points in an image):")
        add(f"            Minimum: {phr[imin]:.3f} pixels (photo {imin+1} over "
            f"{int(rstats['photo_count'][imin])} points)")
        add(f"            Maximum: {phr[imax]:.3f} pixels (photo {imax+1} over "
            f"{int(rstats['photo_count'][imax])} points)")

    add("      Point Precision")
    tot = np.sqrt(np.nansum(std_op**2, axis=1))
    est_pts = np.isfinite(std_op).any(axis=1)
    if est_pts.any():
        jmin = np.flatnonzero(est_pts)[np.argmin(tot[est_pts])]
        jmax = np.flatnonzero(est_pts)[np.argmax(tot[est_pts])]
        add("         Total standard deviation (RMS of X/Y/Z std):")
        add(f"            Minimum: {tot[jmin]:.2g} (OP {p.op_id[jmin]})")
        add(f"            Maximum: {tot[jmax]:.2g} (OP {p.op_id[jmax]})")
        for k, nm in enumerate("XYZ"):
            col = std_op[:, k]
            if np.isfinite(col).any():
                jm = np.nanargmax(col)
                add(f"         Maximum {nm} standard deviation: "
                    f"{col[jm]:.2g} (OP {p.op_id[jm]})")
    add("         Points with high correlations")
    add(f"            Points with correlation above 95%: {len(hi_op)}")
    add(f"            Points with correlation above 99%: "
        f"{len(high_point_correlations(cop, 0.99))}")
    if len(hi_op):
        # Top-5 distinct points by |corr|, signed percentage
        # (bundle_result_file.m:707-722).
        from ..solve.quality import point_correlations

        cc = point_correlations(cop).reshape(-1)
        order = np.argsort(-np.abs(cc))
        add("            Points with highest correlations:")
        printed = set()
        for k in order:
            pt = p.op_id[k // 3]
            if pt in printed:
                continue
            printed.add(pt)
            add(f"               Points {pt}: {100*cc[k]:.2f}")
            if len(printed) >= 5:
                break

    add("      Point Angles")
    for nm, mask in (("CP", p.is_ctrl), ("CCP", p.is_check),
                     ("OP", ~p.is_ctrl & ~p.is_check)):
        a = angles[mask] * 180 / np.pi
        a_ok = np.isfinite(a)
        add(f"         {nm}")
        if a_ok.any():
            ids = p.op_id[mask]
            labels = [p.op_labels[k] for k in np.flatnonzero(mask)]

            def _lab(i):
                # CP/CCP lines carry the point label
                # (bundle_result_file.m:760-787); OP lines do not.
                return (f", label {labels[i]}" if nm != "OP"
                        and labels[i] else "")

            imin = int(np.nanargmin(a))
            imax = int(np.nanargmax(a))
            add(f"            Minimum: {np.nanmin(a):.1f} degrees "
                f"({nm} {ids[imin]}{_lab(imin)})")
            add(f"            Maximum: {np.nanmax(a):.1f} degrees "
                f"({nm} {ids[imax]}{_lab(imax)})")
            add(f"            Average: {np.nanmean(a):.1f} degrees")
            if nm == "OP":
                # Smallest-angle table (bundle_result_file.m:799-817):
                # every point below 1.1x the 3rd-smallest angle
                # + 0.1 deg (capped at 80), at least 3 points.
                order = np.argsort(a)
                lim = min(a[order[min(2, len(order) - 1)]] * 1.1 + 0.1,
                          80.0)
                n_pts = min(max(int((a < lim).sum()), 3), len(order))
                add("            Smallest angles (ID, angle [deg], "
                    "vis in cameras)")
                idx_all = np.flatnonzero(mask)
                for i in order[:n_pts]:
                    jj = idx_all[i]
                    cams = np.sort(
                        p.obs_img[p.obs_pt == jj]) + 1
                    vis = " ".join(f"{c:4d}" for c in cams)
                    add(f"               {ids[i]:6d}: {a[i]:5.2f} "
                        f"({vis})")
        else:
            add("            Minimum: -")
            add("            Maximum: -")
            add("            Average: -")

    # Ctrl/check tables (bundle_result_file.m:819-935: prior and
    # posterior coordinate tables, the pos/std diff table, and the
    # per-axis delta summary).
    def _pt_tables(mask, kind):
        sel = np.flatnonzero(mask)
        ids = p.op_id[sel]
        add("         Prior")
        add("             id,        x,        y,        z,     stdx,"
            "     stdy,     stdz, label")
        for j in sel:
            v = p.prior_op_val[j]
            sd = p.prior_op_std[j]
            add(f"         {p.op_id[j]:6d}, {v[0]:8.3f}, {v[1]:8.3f}, "
                f"{v[2]:8.3f}, {sd[0]:8.3g}, {sd[1]:8.3g}, {sd[2]:8.3g}, "
                f"{p.op_labels[j]}")
        add("         Posterior")
        add("             id,        x,        y,        z,     stdx,"
            "     stdy,     stdz, rays, label")
        for j in sel:
            v = p.op[j]
            sd = np.nan_to_num(std_op[j])
            add(f"         {p.op_id[j]:6d}, {v[0]:8.3f}, {v[1]:8.3f}, "
                f"{v[2]:8.3f}, {sd[0]:8.3g}, {sd[1]:8.3g}, {sd[2]:8.3g}, "
                f"{int(rays[j]):4d}, {p.op_labels[j]}")
        d = p.op[sel] - p.prior_op_val[sel]
        eps = np.finfo(float).eps
        std1 = np.nan_to_num(std_op[sel])
        std0 = np.asarray(p.prior_op_std[sel], float)
        stdd = ((std1 + eps) / (std0 + eps) - 1.0) * 100.0
        add("         Diff (pos=abs diff, std=rel diff)")
        add("             id,        x,        y,        z,       xy,"
            "      xyz,     stdx,     stdy,     stdz, rays, label")
        for k, j in enumerate(sel):
            add(f"         {p.op_id[j]:6d}, {d[k,0]:8.3f}, "
                f"{d[k,1]:8.3f}, {d[k,2]:8.3f}, "
                f"{np.hypot(d[k,0], d[k,1]):8.3f}, "
                f"{np.linalg.norm(d[k]):8.3f}, {stdd[k,0]:7.1f}%, "
                f"{stdd[k,1]:7.1f}%, {stdd[k,2]:7.1f}%, "
                f"{int(rays[j]):4d}, {p.op_labels[j]}")
        dn = np.linalg.norm(d, axis=1)
        jm = int(np.argmax(dn))
        lab = p.op_labels[sel[jm]]
        add(f"         {kind} point delta")
        add(f"            Max: {dn[jm]:.3f} ou ({lab}, pt {ids[jm]})")
        add("            Max X,Y,Z")
        for ax, nm in enumerate("XYZ"):
            ja = int(np.argmax(np.abs(d[:, ax])))
            add(f"               {nm}: {np.abs(d[ja, ax]):.3f} ou "
                f"({p.op_labels[sel[ja]]}, pt {ids[ja]})")
        add(f"            RMS: {np.sqrt(np.mean(dn**2)):.3f} ou "
            f"(from {len(sel)} items)")

    add("      Ctrl measurements")
    if n_cp:
        _pt_tables(p.is_ctrl, "Ctrl")
    else:
        add("         none")
    add("      Check measurements")
    if n_ccp:
        _pt_tables(p.is_check, "Check")
    else:
        add("         none")
    add("End of result file")

    with open(path, "wt") as fh:
        fh.write("\n".join(L) + "\n")

    return {
        "cov": cov, "sig": sig, "corr_io": corr_io,
        "corr_io_cross": corr_io_cross, "corr_eo": corr_eo,
        "rstats": rstats, "angles": angles, "rays": rays,
        "std_io": std_io, "std_eo": std_eo, "std_op": std_op,
        "cov_times": {"prep": t_prep, "cio": t_cio, "ceo": t_ceo,
                      "cop": t_cop},
    }
