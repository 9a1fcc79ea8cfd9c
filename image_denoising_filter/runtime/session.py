"""Session: the orchestrator that runs one denoising configuration end-to-end.

The equivalent of `ComputeApplication::RunOnGPU`
(src/main.cpp:1307-1730): dataset discovery -> image loading -> host->device
upload -> jit-compiled kernel dispatch -> readback -> flag-encoded encode, with
the per-run transfer/exec timing report (PRINT_TIME analog). Descriptor sets,
pipelines and command buffers have no analog -- XLA owns binding and
scheduling; a RunConfig maps directly onto a compiled model.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    BilateralParams,
    BorderPolicy,
    CpuBilateralParams,
    LayersParams,
    NlmParams,
    RunConfig,
    TilingConfig,
)
from ..models.denoiser import (
    LINEAR,
    TILED,
    BilateralDenoiser,
    LayerGuidedDenoiser,
    NlmDenoiser,
    TemporalNlmDenoiser,
)
from ..parallel import (
    make_mesh,
    spatial_bilateral,
    spatial_cross_bilateral_layers,
    spatial_nlm_accumulate,
    temporal_nlm_sharded,
)
from ..ops import reference as ref_ops
from ..utils import dataset as dataset_mod
from ..utils import imageio
from ..utils.progress import ProgressBar
from ..utils.timing import Timer, TimingReport, print_cpu_time
from .prefetch import FramePrefetcher


@dataclasses.dataclass
class RunResult:
    config: RunConfig
    output_path: str
    image: np.ndarray
    report: TimingReport


class Session:
    """Runs RunConfigs against one target image (re-usable across configs,
    like the reference app object re-running RunOnGPU)."""

    def __init__(
        self,
        target: str,
        bilateral_params: BilateralParams = BilateralParams(),
        layers_params: LayersParams = LayersParams(),
        nlm_params: NlmParams = NlmParams(),
        tiling: Optional[TilingConfig] = None,
        output_dir: str = ".",
        clamp_output: bool = False,
        warmup: bool = True,
        debug_weights: bool = False,
        mesh_shape: Optional[tuple[int, int]] = None,
        frame_cache: Optional[dict] = None,
        batch_frames: bool = False,
    ) -> None:
        self.target = target
        self.bilateral_params = bilateral_params
        self.layers_params = layers_params
        self.nlm_params = nlm_params
        self.tiling = tiling
        self.output_dir = output_dir
        self.clamp_output = clamp_output
        # Compile (jit) before the timed region, so the exec report measures
        # steady-state device time like the reference's Vulkan timestamps
        # (pipeline creation happens outside the query range, main.cpp:690-727).
        self.warmup = warmup
        # Sample and print accumulated (weightColor, normWeight) values after
        # the NLM/layers accumulation -- the reference carries this as a
        # disabled `if (0)` debug block over a host-visible weights buffer
        # (src/main.cpp:1628-1647); here it's a real option.
        self.debug_weights = debug_weights
        # (frame, y) mesh for multi-device runs: rows shard over 'y' with
        # halo exchange; multiframe NLM partials psum over 'frame'. None =
        # single-device (the reference's deviceId-0 mode, src/main.cpp:1321).
        self.mesh = make_mesh(mesh_shape) if mesh_shape else None
        # Non-overlap multiframe NLM as ONE frame-batched kernel launch:
        # frames upload as a single stacked transfer and the weight
        # accumulators stay in registers across the frames
        # (ops.nlm_accumulate_frames) instead of one dispatch + fence per
        # frame. Same math/partials; the per-frame dispatch parity with the
        # reference's loop (src/main.cpp:1574-1607) is why it's opt-in.
        self.batch_frames = batch_frames
        # Optional decoded-frame LRU shared across Sessions (serving mode
        # re-targets over the same neighbor frames; without a cache an
        # N-frame directory costs O(N^2) decodes).
        self._frame_cache = frame_cache
        self.is_hdr = imageio.is_hdr_path(target)
        # Touch the backend so device/runtime initialization (the analog of
        # vk_utils::CreateInstance/CreateLogicalDevice, timed *outside* the
        # reference's query range) is not attributed to the first transfer.
        jax.block_until_ready(jax.device_put(np.float32(0.0)))

    _FRAME_CACHE_MAX = 32  # decoded frames kept when a cache dict is shared

    def _load(self, path: str) -> np.ndarray:
        if self._frame_cache is None:
            return imageio.load(path)[0]
        if path in self._frame_cache:
            self._frame_cache[path] = self._frame_cache.pop(path)  # LRU touch
            return self._frame_cache[path]
        img = imageio.load(path)[0]
        self._frame_cache[path] = img
        while len(self._frame_cache) > self._FRAME_CACHE_MAX:
            self._frame_cache.pop(next(iter(self._frame_cache)))
        return img

    # -- GPU-path equivalent ------------------------------------------------

    def run(self, cfg: RunConfig) -> RunResult:
        report = TimingReport()
        # The 10-frame cap is an overlap-path behavior in the reference
        # (src/main.cpp:1341,1554); the plain multiframe loop uses all frames.
        ds = dataset_mod.discover(
            self.target,
            multiframe=cfg.multiframe,
            use_layers=cfg.use_layers,
            max_frames=cfg.max_frames if cfg.overlap else None,
        )
        target_host = self._load(ds.target)

        # Exact uniform-alpha fast path: when the target's alpha channel is a
        # single constant AND the border policy is CLAMP (edge padding
        # preserves the constant; ZERO padding injects alpha-0 taps with
        # nonzero weight, breaking sum(w*a) == a*sum(w) at borders), kernels
        # skip the per-tap alpha accumulation. Applied where the alpha taps
        # provably come from the target (bilateral, layers, single-frame NLM);
        # multiframe keeps the user's setting since frames stream in lazily.
        from ..config import BorderPolicy

        a = target_host[..., 3]
        ua = bool(a.min() == a.max())

        def _ua_ok(params):
            return ua and params.border == BorderPolicy.CLAMP and not params.uniform_alpha

        bilateral_params = (
            dataclasses.replace(self.bilateral_params, uniform_alpha=True)
            if _ua_ok(self.bilateral_params)
            else self.bilateral_params
        )
        layers_params = (
            dataclasses.replace(self.layers_params, uniform_alpha=True)
            if _ua_ok(self.layers_params)
            else self.layers_params
        )
        nlm_single_params = (
            dataclasses.replace(self.nlm_params, uniform_alpha=True)
            if _ua_ok(self.nlm_params) and not cfg.multiframe
            else self.nlm_params
        )

        layout = LINEAR if cfg.linear else TILED

        if self.mesh is None:  # the sharded path uploads its own row shards
            with report.transfer():
                target_dev = jax.device_put(target_host)
        if self.mesh is not None:
            out_dev = self._run_sharded(
                target_host, ds, report, cfg, bilateral_params, layers_params, nlm_single_params
            )
        elif cfg.use_layers:
            out_dev = self._run_layers(target_dev, ds, report, layout, layers_params)
        elif cfg.nlm and cfg.multiframe:
            out_dev = self._run_multiframe(target_dev, ds, report, layout, cfg)
        elif cfg.nlm:
            model = NlmDenoiser(nlm_single_params, layout=layout, tiling=self.tiling)
            if self.warmup:
                jax.block_until_ready(model(target_dev))
            with report.execute():
                out_dev = model(target_dev)
                jax.block_until_ready(out_dev)
        else:
            model = BilateralDenoiser(
                bilateral_params, layout=layout, tiling=self.tiling
            )
            if self.warmup:
                jax.block_until_ready(model(target_dev))
            with report.execute():
                out_dev = model(target_dev)
                jax.block_until_ready(out_dev)

        with report.transfer():
            out_host = np.asarray(out_dev)

        name = cfg.output_name(self.is_hdr)
        path = os.path.join(self.output_dir, name)
        imageio.save(path, out_host, hdr=self.is_hdr, clamp=self.clamp_output)
        return RunResult(config=cfg, output_path=path, image=out_host, report=report)

    def _row_padding(self, h: int, halo: int, border: str) -> tuple[int, str]:
        """(pad_rows, numpy-pad mode) so H divides the 'y' axis size AND each
        shard has at least `halo` rows (a shard cannot source a halo strip
        larger than itself). The pad mode follows the run's border policy
        (edge pad == CLAMP taps, zero pad == ZERO taps)."""
        n_y = self.mesh.devices.shape[1]
        rows = max(-(-h // n_y), halo)
        mode = "edge" if border == BorderPolicy.CLAMP else "constant"
        return rows * n_y - h, mode

    def _put_rows(self, img, halo: int, border: str):
        """Row-pad a host (H, W, 4) image per _row_padding and upload it
        sharded by rows over 'y', so each device receives only its own rows.
        Returns (device array, original H); outputs are cropped to H."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import SPATIAL_AXIS

        h = img.shape[0]
        ph, mode = self._row_padding(h, halo, border)
        if ph:
            img = np.pad(img, ((0, ph), (0, 0), (0, 0)), mode=mode)
        rows = NamedSharding(self.mesh, P(SPATIAL_AXIS, None, None))
        return jax.device_put(img, rows), h

    def _run_sharded(self, target_host, ds, report, cfg, bp, lp, nlm_single):
        """Multi-chip dispatch: spatial row sharding (+ frame DP for
        multiframe NLM). Linear-layout configs shard the XLA variant over the
        same mesh (the reference's layout experiment, preserved under
        sharding)."""
        linear = cfg.linear
        if cfg.use_layers:
            halo, border = lp.effective_radius, lp.border
        elif cfg.nlm:
            # nlm_single == self.nlm_params for multiframe configs (run()
            # only auto-adjusts it for single-frame NLM)
            halo, border = nlm_single.halo, nlm_single.border
        else:
            halo, border = bp.effective_radius, bp.border
        with report.transfer():
            tgt, h = self._put_rows(target_host, halo, border)
        if cfg.use_layers:
            wc = nw = None
            for p in ds.layers:
                with report.transfer():
                    layer, _ = self._put_rows(self._load(p), halo, border)
                pwc, pnw = spatial_cross_bilateral_layers(
                    tgt, layer, lp, self.mesh, self.tiling, linear=linear
                )
                wc = pwc if wc is None else wc + pwc
                nw = pnw if nw is None else nw + pnw
            from ..ops import normalize as norm_op

            if wc is None:
                hh, ww, _ = tgt.shape
                wc = jnp.zeros((hh, ww, 4), jnp.float32)
                nw = jnp.zeros((hh, ww), jnp.float32)
            with report.execute():
                out = norm_op(wc, nw)
                jax.block_until_ready(out)
            return out[:h]
        if cfg.nlm and cfg.multiframe:
            # Same frame-selection rule as _run_multiframe: the overlap loop
            # never dispatches the final uploaded frame (src/main.cpp:1554-1572).
            paths = list(ds.frames)
            if cfg.overlap and len(paths) > 1:
                paths = paths[:-1]
            return self._run_sharded_temporal(
                tgt, paths, report, halo, border, linear
            )[:h]
        if cfg.nlm:
            from ..ops import normalize as norm_op

            with report.execute():
                wc, nw = spatial_nlm_accumulate(
                    tgt, tgt, nlm_single, self.mesh, self.tiling, linear=linear
                )
                out = norm_op(wc, nw)
                jax.block_until_ready(out)
            return out[:h]
        with report.execute():
            out = spatial_bilateral(tgt, bp, self.mesh, self.tiling, linear=linear)
            jax.block_until_ready(out)
        return out[:h]

    def _run_sharded_temporal(self, tgt, paths, report, halo, border, linear):
        """Streamed multichip temporal NLM: frames are uploaded and consumed
        in chunks of the mesh's 'frame' axis size, with the NEXT chunk's
        host->device transfer issued before blocking on the current chunk's
        kernels (the multichip form of the copy/compute overlap). Partials
        accumulate on device; one normalize at the end -- the single-chip
        dispatch count is len(paths) accumulate kernels + 1 normalize, same
        as the reference's loop (src/main.cpp:1554-1624, 1649-1652)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..config import BorderPolicy
        from ..parallel.mesh import FRAME_AXIS, SPATIAL_AXIS
        from ..parallel.spatial import temporal_nlm_sharded_partials
        from ..ops import normalize

        n_f = self.mesh.devices.shape[0]
        sharding = NamedSharding(self.mesh, P(FRAME_AXIS, SPATIAL_AXIS, None, None))
        mode = "edge" if border == BorderPolicy.CLAMP else "constant"
        hp = int(tgt.shape[0])  # tgt is already row-padded to the shard grid

        def upload_chunk(chunk_paths):
            frames = [self._load(p) for p in chunk_paths]
            n_pad = n_f - len(frames)
            valid = np.concatenate(
                [np.ones(len(frames), np.float32), np.zeros(n_pad, np.float32)]
            )
            frames += [np.zeros_like(frames[0])] * n_pad
            if frames[0].shape[0] != hp:
                frames = [
                    np.pad(
                        f, ((0, hp - f.shape[0]), (0, 0), (0, 0)), mode=mode
                    )
                    for f in frames
                ]
            with report.transfer():
                dev = jax.device_put(np.stack(frames), sharding)
                vdev = jax.device_put(valid, NamedSharding(self.mesh, P()))
            return dev, vdev

        chunks = [paths[i : i + n_f] for i in range(0, len(paths), n_f)]
        pending = upload_chunk(chunks[0]) if chunks else None
        wc = nw = None
        with report.execute():
            for ci in range(len(chunks)):
                frames_dev, valid_dev = pending
                # Issue the next chunk's upload BEFORE consuming this one:
                # device_put is async, so the DMA runs under the kernels.
                if ci + 1 < len(chunks):
                    pending = upload_chunk(chunks[ci + 1])
                pwc, pnw = temporal_nlm_sharded_partials(
                    tgt,
                    frames_dev,
                    self.nlm_params,
                    mesh=self.mesh,
                    tiling=self.tiling,
                    valid=valid_dev,
                    linear=linear,
                )
                wc = pwc if wc is None else wc + pwc
                nw = pnw if nw is None else nw + pnw
            # Pointwise epilogue: GSPMD partitions the normalize along the
            # existing row sharding.
            out = normalize(wc, nw)
            jax.block_until_ready(out)
        return out

    def _dump_weights(self, wc, nw) -> None:
        wc = np.asarray(wc)
        nw = np.asarray(nw)
        h, w = nw.shape
        for y in range(h // 4, h * 3 // 4, 50):
            for x in range(0, w, 50):
                c = wc[y, x]
                print(
                    f"({x}; {y}) => | {c[0]:.6g} {c[1]:.6g} {c[2]:.6g} | "
                    f"{nw[y, x]:.6g}"
                )

    def _run_layers(self, target_dev, ds, report, layout, layers_params):
        """Per-layer accumulate then normalize (src/main.cpp:1608-1624,
        1649-1652). Layers are always LDR (loaded with a_isHDR=false,
        src/main.cpp:1396)."""
        model = LayerGuidedDenoiser(
            layers_params, layout=layout, tiling=self.tiling
        )
        layers_host = [self._load(p) for p in ds.layers]
        if not layers_host:
            # No layers found: accumulators stay zero and normalize paints the
            # magenta sentinel everywhere, like the reference would.
            from ..ops import normalize as norm_op

            h, w, _ = target_dev.shape
            with report.execute():
                out = norm_op(
                    jnp.zeros((h, w, 4), jnp.float32), jnp.zeros((h, w), jnp.float32)
                )
                jax.block_until_ready(out)
            return out
        with report.transfer():
            layers_dev = jax.device_put(np.stack(layers_host))
        if self.warmup:
            jax.block_until_ready(model(target_dev, layers_dev))
        with report.execute():
            out = model(target_dev, layers_dev)
            jax.block_until_ready(out)
        return out

    def _run_multiframe(self, target_dev, ds, report, layout, cfg):
        """Temporal NLM over neighbor frames (src/main.cpp:1554-1624).

        overlap=True streams frames through the double-buffered prefetcher
        (upload of frame k+1 in flight under frame k's kernel -- the
        copy/compute overlap analog); overlap=False uploads then computes
        frame-by-frame, like the reference's non-overlapped loop.
        """
        model = TemporalNlmDenoiser(self.nlm_params, layout=layout, tiling=self.tiling)
        # Per-frame uniform-alpha fast path (non-overlap loop only, where the
        # host array is at hand): a frame whose alpha is one constant takes
        # the fast kernel; mixing fast/slow per-frame partials stays exact
        # because each frame's partial is exact. CLAMP border required (see
        # run()); the overlap path streams device arrays, so it keeps the
        # configured kernel.
        from ..config import BorderPolicy

        fast_ok = (
            self.nlm_params.border == BorderPolicy.CLAMP
            and not self.nlm_params.uniform_alpha
        )
        model_fast = (
            TemporalNlmDenoiser(
                dataclasses.replace(self.nlm_params, uniform_alpha=True),
                layout=layout,
                tiling=self.tiling,
            )
            if fast_ok
            else model
        )

        def pick_model(frame_host):
            a = frame_host[..., 3]
            return model_fast if fast_ok and a.min() == a.max() else model

        if self.warmup and not (self.batch_frames and not cfg.overlap):
            # Warm the variant that will actually dispatch: the overlap path
            # streams device arrays and always uses the configured kernel;
            # the non-overlap path picks per-frame by alpha, so warm the
            # variant the target's own alpha selects (the common case: all
            # frames share it); the other compiles on first use. (The
            # batch-frames path warms its own batched program instead.)
            wmodel = model if cfg.overlap else pick_model(np.asarray(target_dev))
            warm = wmodel.accumulate_one(target_dev, target_dev, None)
            warm = wmodel.accumulate_one(target_dev, target_dev, warm)  # +carry path
            jax.block_until_ready(wmodel.finalize(warm))
        carry = None
        bar = ProgressBar(label="frames")
        if cfg.overlap:
            # Reference parity: the overlap loop dispatches NLM on the
            # *previous* texture while copying frame ii (src/main.cpp:1554-
            # 1572), so the final uploaded frame is never filtered -- only
            # frames[0 .. framesToUse-2] accumulate (9 dispatches for 10
            # frames).
            consumed = ds.frames[:-1] if len(ds.frames) > 1 else ds.frames
            frames = FramePrefetcher(
                consumed,
                lambda p: imageio.load(p)[0],
                depth=2,
                report=report,
                native_paths=True,
            )
            with report.execute():
                for i, frame_dev in enumerate(frames):
                    carry = model.accumulate_one(target_dev, frame_dev, carry)
                    bar.progress(i + 1, len(frames))
                bar.finish()
                if self.debug_weights:
                    self._dump_weights(carry[0], carry[1])
                out = model.finalize(carry)
                jax.block_until_ready(out)
        elif self.batch_frames:
            # Stacked transfer + frame-batched kernel launch: the (wc, nw)
            # accumulators stay in registers across the frames instead of
            # paying a dispatch + sync + partials round-trip per frame.
            # Exact same partials as the streamed loop (tested). Memory guard:
            # stacking a long 4K sequence whole multiplies peak host+device
            # memory by the frame count, so the stack is
            # chunked at ~1.5 GB; each chunk still batches its frames in one
            # launch and chunk partials add exactly.
            n = len(ds.frames)
            h_t, w_t, _ = target_dev.shape
            frame_bytes = h_t * w_t * 4 * 4
            chunk = max(1, min(n, int(1.5e9 // max(1, frame_bytes))))
            total_wc = total_nw = None
            warmed: set = set()
            for start_i in range(0, n, chunk):
                frames_host = [
                    self._load(p) for p in ds.frames[start_i : start_i + chunk]
                ]
                bar.progress(min(start_i + chunk, n), n)
                all_uniform = fast_ok and all(
                    f[..., 3].min() == f[..., 3].max() for f in frames_host
                )
                bmodel = model_fast if all_uniform else model
                with report.transfer():
                    frames_dev = jax.device_put(np.stack(frames_host))
                    jax.block_until_ready(frames_dev)
                # Warm every DISTINCT program this loop will dispatch, not
                # just the first chunk's: the tail chunk (n % chunk frames)
                # has a different stacked shape, and a chunk whose alpha
                # uniformity flips swaps bmodel -- either would otherwise
                # compile inside the timed execute block below.
                warm_key = (frames_dev.shape, bmodel is model_fast)
                if self.warmup and warm_key not in warmed:
                    warm = bmodel.accumulate(target_dev, frames_dev)
                    jax.block_until_ready(bmodel.finalize(warm))
                    warmed.add(warm_key)
                with report.execute():
                    wc, nw = bmodel.accumulate(target_dev, frames_dev)
                    if total_wc is None:
                        total_wc, total_nw = wc, nw
                    else:
                        total_wc = total_wc + wc
                        total_nw = total_nw + nw
                    jax.block_until_ready(total_nw)
            bar.finish()
            with report.execute():
                if self.debug_weights:
                    self._dump_weights(total_wc, total_nw)
                out = model.finalize((total_wc, total_nw))
                jax.block_until_ready(out)
            return out
        else:
            for i, p in enumerate(ds.frames):
                host = self._load(p)
                fmodel = pick_model(host)
                with report.transfer():
                    frame_dev = jax.device_put(host)
                    jax.block_until_ready(frame_dev)
                with report.execute():
                    carry = fmodel.accumulate_one(target_dev, frame_dev, carry)
                    jax.block_until_ready(carry[1])
                bar.progress(i + 1, len(ds.frames))
            bar.finish()
            if self.debug_weights:
                self._dump_weights(carry[0], carry[1])
            with report.execute():
                out = model.finalize(carry)
                jax.block_until_ready(out)
        return out

    def run_turbo(
        self, cfg: RunConfig, levels: int | None = None, downsample: int = 2
    ) -> RunResult:
        """Approximate bilateral-grid mode for the bilateral and layers
        configs (opt-in; quality vs the exact kernel is gated in
        tests/test_fast.py -- see ops/fast.py). Writes the same flag-encoded
        output name. levels=None resolves the per-d default: K=5 at
        downsample 2 and 4 for BOTH families, K=6 everywhere else (at
        1080p, K=6-8 add at most 0.25 dB over K=5 at those d). Single device
        only: the sharded grid paths were removed."""
        assert not cfg.nlm, "turbo NLM runs through run() with search_stride"
        if self.mesh is not None:
            raise ValueError(
                "the approximate bilateral-grid mode runs on one device only; "
                "drop the mesh or run the exact kernels"
            )
        from ..ops.fast import bilateral_fast

        if levels is None:
            levels = 5 if downsample in (2, 4) else 6

        if downsample >= 8 and self.bilateral_params.sigma_spatial < 5.0:
            # A CPU quality screen put an 8-px grid cell + bilinear
            # reconstruction below the 40 dB gate vs exact at sigma_s=2; it
            # passes from sigma_s ~5-6 up.
            print(
                "note: --turbo 8 with sigma_spatial="
                f"{self.bilateral_params.sigma_spatial:g} falls below the"
                " 40 dB quality gate vs the exact kernel (crossover at"
                " sigma_s ~5-6). Use --turbo 4 or a larger --sigma-spatial."
            )

        if cfg.use_layers:
            return self._run_turbo_layers(cfg, levels, downsample)

        report = TimingReport()
        target_host = self._load(self.target)
        with report.transfer():
            target_dev = jax.device_put(target_host)
        bp = self.bilateral_params

        def run():
            return bilateral_fast(target_dev, bp, levels, downsample)

        return self._finish_turbo(cfg, report, run)

    def _run_turbo_layers(self, cfg: RunConfig, levels: int, downsample: int) -> RunResult:
        """TURBO layer-guided config: per layer, unnormalized guided-grid
        (num, den) partials accumulate like the exact two-pass pipeline
        (src/main.cpp:1608-1624), then one per-channel divide with the
        magenta sentinel. Approximation figures in tests/test_fast.py."""
        from ..ops.fast import cross_bilateral_layers_fast, normalize_layers_fast

        report = TimingReport()
        ds = dataset_mod.discover(self.target, multiframe=False, use_layers=True)
        target_host = self._load(ds.target)
        with report.transfer():
            target_dev = jax.device_put(target_host)
        lp = self.layers_params
        layers_host = [self._load(p) for p in ds.layers]
        with report.transfer():
            layers_dev = [jax.device_put(x) for x in layers_host]
            jax.block_until_ready(layers_dev)

        def run():
            h, w, _ = target_dev.shape
            wc = jnp.zeros((h, w, 4), jnp.float32)
            nw = jnp.zeros((h, w, 3), jnp.float32)
            for layer_dev in layers_dev:
                pwc, pnw = cross_bilateral_layers_fast(
                    target_dev, layer_dev, lp, levels, downsample
                )
                wc = wc + pwc
                nw = nw + pnw
            return normalize_layers_fast(wc, nw)

        return self._finish_turbo(cfg, report, run)

    def _finish_turbo(self, cfg: RunConfig, report: TimingReport, run) -> RunResult:
        """Warm, time one run, read back and write the output file."""
        if self.warmup:
            jax.block_until_ready(run())
        with report.execute():
            out_dev = run()
            jax.block_until_ready(out_dev)
        with report.transfer():
            out_host = np.asarray(out_dev)
        name = cfg.output_name(self.is_hdr)
        path = os.path.join(self.output_dir, name)
        imageio.save(path, out_host, hdr=self.is_hdr, clamp=self.clamp_output)
        return RunResult(config=cfg, output_path=path, image=out_host, report=report)

    # -- CPU-path equivalent ------------------------------------------------

    def run_cpu(self, num_threads: int = 1) -> tuple[str, float]:
        """The CPU bilateral reference (RunOnCPU, src/main.cpp:1732-1921):
        window 10, sigma_s 10, sigma_c 0.2, blue-channel bug, zeroed border,
        output-cpu.{png,exr}. Uses the native OpenMP oracle when built, else
        the NumPy oracle (num_threads honored by the native path)."""
        timer = Timer()
        img, is_hdr = imageio.load(self.target)
        params = CpuBilateralParams()
        try:
            from ..utils.native import cpu_bilateral as native_bilateral

            out = native_bilateral(img, params, num_threads)
        except (ImportError, OSError):
            out = ref_ops.cpu_bilateral_reference(img, params)
        name = "output-cpu" + (".exr" if is_hdr else ".png")
        path = os.path.join(self.output_dir, name)
        imageio.save(path, out, hdr=is_hdr, clamp=self.clamp_output)
        return path, timer.elapsed()
