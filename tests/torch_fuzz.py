"""The syntax-matrix sampler of tests/test_fuzz_matrix.py (rng seeds
911-966), copied onto the port's encoder so the card tests can draw the
same configs where the JAX package is not installed;
tests/test_torch_fuzz_lo.py holds the copy to the original."""
import numpy as np

from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder

N_CONFIGS = 56


def sample_config(rng):
    """One valid config drawn from the syntax matrix (the copy of
    ``tests/test_fuzz_matrix._sample_config``)."""
    log2_ctb = int(rng.choice([4, 5, 6], p=[0.3, 0.4, 0.3]))
    w = int(rng.choice([48, 64, 80, 96, 120]))
    h = int(rng.choice([32, 48, 64, 72]))
    chroma = int(rng.choice([1, 1, 1, 2, 3]))
    bd = int(rng.choice([8, 8, 8, 10, 12]))
    gop = str(rng.choice(["all_intra", "ipp", "ipp", "lowb", "ra"]))
    kw = dict(
        width=w, height=h, qp=int(rng.integers(20, 45)),
        log2_ctb_size=log2_ctb,
        log2_cu_size=int(rng.integers(3, log2_ctb + 1)),
        chroma_format_idc=chroma, bit_depth=bd,
        split_policy=str(rng.choice(["fixed", "variance", "random"])),
        max_transform_hierarchy_depth_intra=int(rng.integers(0, 3)),
        nxn_probability=float(rng.uniform(0.2, 0.8)),
        tu_split_probability=float(rng.uniform(0.2, 0.8)),
        seed=int(rng.integers(0, 1 << 30)),
        transform_skip=bool(rng.random() < 0.3),
        deblocking=bool(rng.random() < 0.5),
        sao=bool(rng.random() < 0.5),
        gop=gop,
        search_range=int(rng.integers(1, 4)),
    )
    inter = gop != "all_intra"
    if inter:
        kw["tmvp"] = bool(rng.random() < 0.4)
        kw["weighted_pred"] = bool(rng.random() < 0.25)
        if gop in ("ipp", "lowb") and rng.random() < 0.25:
            kw["long_term_ref"] = True if rng.random() < 0.5 else "mod"
    if gop == "ra" and rng.random() < 0.4:
        kw["cra_anchors"] = True
    # parallel entropy structures: wpp, tiles, or wpp-in-tiles
    r = rng.random()
    if r < 0.3:
        kw["wpp"] = True
    elif r < 0.55:
        ctb = 1 << log2_ctb
        kw["tiles"] = (min(int(rng.integers(1, 3)), max(1, w // ctb)),
                       min(int(rng.integers(1, 3)), max(1, h // ctb)))
        if kw["tiles"] == (1, 1):
            kw.pop("tiles")
        elif rng.random() < 0.3:
            kw["wpp"] = True
        if "tiles" in kw and rng.random() < 0.3:
            kw["lf_across_tiles"] = False
    if rng.random() < 0.3:
        nt = kw.get("tiles", (1, 1))[0] * kw.get("tiles", (1, 1))[1]
        ctb_rows = max(1, h >> log2_ctb)
        slices = min(int(rng.integers(2, 4)), max(2, ctb_rows))
        if nt > 1:
            slices = nt  # whole-tile runs
        if slices > 1:
            kw["slices"] = slices
        if rng.random() < 0.5:
            kw["slice_filter_params"] = (
                {"beta_offset": 2, "tc_offset": -2},
                {"disable": True},
                {"lf_across": False})
    elif rng.random() < 0.2 and not kw.get("wpp"):
        kw["dependent_slices"] = int(rng.integers(1, 3))
    if rng.random() < 0.2:
        kw["pcm"] = "all" if rng.random() < 0.3 else 0.4
        kw["pcm_bit_depth"] = int(rng.choice([0, max(8, bd - 2)]))
        kw["pcm_loop_filter_disabled"] = bool(rng.random() < 0.5)
    if rng.random() < 0.25:
        kw["cu_qp_delta_depth"] = int(rng.integers(0, 2))
    if inter and log2_ctb <= 5 and rng.random() < 0.25:
        kw["amp"] = 0.6
    if rng.random() < 0.2:
        kw["scaling_lists"] = str(rng.choice(["default", "custom"]))
    # rext tools
    if rng.random() < 0.3:
        if kw["transform_skip"] and rng.random() < 0.5:
            kw["rext_persistent_rice"] = True
            kw["rext_ts_context"] = bool(rng.random() < 0.5)
        if kw["transform_skip"] and not kw.get("scaling_lists") \
                and rng.random() < 0.4:
            kw["rext_ts_rotation"] = True
        if rng.random() < 0.3:
            kw["rext_implicit_rdpcm"] = True
            kw["transform_skip"] = True
        if inter and log2_ctb <= 5 and rng.random() < 0.25:
            kw["rext_explicit_rdpcm"] = True
        if chroma == 3 and rng.random() < 0.4:
            kw["rext_ccp"] = True
        if rng.random() < 0.3:
            kw["rext_chroma_qp_offsets"] = ((2, -2), (0, 3))
    return EncoderConfig(**kw)


def frames_for(cfg, rng, n):
    """The copy of ``tests/test_fuzz_matrix._frames_for``."""
    sub_w = 2 if cfg.chroma_format_idc in (1, 2) else 1
    sub_h = 2 if cfg.chroma_format_idc == 1 else 1
    w, h = cfg.width, cfg.height
    hi = (1 << cfg.bit_depth) - 1
    base = [rng.integers(0, 256, (h, w)),
            rng.integers(0, 256, (h // sub_h, w // sub_w)),
            rng.integers(0, 256, (h // sub_h, w // sub_w))]
    # smooth half the content so inter prediction + filters engage
    for p in base:
        p[: p.shape[0] // 2] = (p[: p.shape[0] // 2] // 8) * 8
    out = []
    for t in range(n):
        planes = [np.roll(p, (t * 3, t * 5), (0, 1)) for p in base]
        scale = (hi + 1) // 256
        out.append([np.clip(p * scale, 0, hi).astype(
            np.uint8 if cfg.bit_depth == 8 else np.uint16)
            for p in planes])
    return out


def fuzz_stream(seed):
    """(config, stream) of fuzz seed ``seed`` (rng seed 911 + seed), as
    tests/test_fuzz_matrix.py encodes it."""
    rng = np.random.default_rng(911 + seed)
    cfg = sample_config(rng)
    n = 1 if cfg.gop == "all_intra" else (4 if cfg.gop == "ra" else 3)
    enc = IntraEncoder(cfg)
    return cfg, b"".join(enc.encode_frame(p)
                         for p in frames_for(cfg, rng, n))
