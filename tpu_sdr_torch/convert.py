"""Hand weights and streaming state between the JAX package and the port.

Everything crosses as numpy arrays (``np.asarray`` of a JAX array), so this
module never imports jax.  The float chain's six-field ``WbfmState`` and
the exact chain's ``WbfmExactState`` convert field for field (a stacked
station-batch state keeps its station axis); the fused chain's and its
batch's carries keep the kernel layout.  The fused chain's state has the JAX kernel's
layout, so the (4, 128) carry, the resampler history and the fs/4 phase
convert 1:1; the weights convert from the TPU kernel's forms — the
split-bf16 banded decimator ``(W_hi, W_lo)`` and the packed resampler
frame matrix ``V`` — to the port's effective taps and polyphase bank.

The wideband receiver converts the same way: the XLA front's ``PfbState``
and the fused front's (2H, K) carry keep their layouts and scales (the
former normalised, the latter x255; ``fused_channelizer`` converts between
the two), the stacked discriminator and resampler states keep their
station axis, and the weights come from the JAX ``WidebandParams`` (K3's
tap table is its ``h_poly``) and the Pallas ``(M2_hi, M2_lo)`` pair.

The stereo decoder's eleven carries, RDS's four, the narrowband modes'
nine and the PSD accumulator convert field for field (the fs/4 phase, the
SSB phase indices and the segment count as ints); their weights convert
from the JAX params, a split-bf16 decimator (the narrowband front's
always, the stereo front's by default) as its effective f32 weights
``255 * (W_hi + W_lo)``.

The sharded chains' streaming carries keep the JAX shapes: the fused
chain's ``(kernel_edge (stations, 4, 128), rs_edge (stations, T-1))`` and
the float chain's ``XlaStreamCarry``; a ``ShardedPallasStreamer`` hands its
carries to a ``ShardedFusedStreamer`` and back.

Every array handed out is a copy: a streamer's carries are the static
buffers of its graphed step (``utils.graphs``), which its next call
rewrites in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_sdr_torch.models import multimode as MM
from tpu_sdr_torch.models import rds as R
from tpu_sdr_torch.models import wbfm as M
from tpu_sdr_torch.models import wbfm_exact as WE
from tpu_sdr_torch.models import wbfm_stereo as ST
from tpu_sdr_torch.models import wbfm_wideband as WB
from tpu_sdr_torch.ops import channelizer as chan
from tpu_sdr_torch.ops import exact as X
from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.ops import spectrum as SP
from tpu_sdr_torch.ops.fused_fm import FusedWbfmSpec, effective_taps
from tpu_sdr_torch.parallel.mesh import Mesh
from tpu_sdr_torch.parallel.wbfm_sharded import XlaStreamCarry
from tpu_sdr_torch.parallel.wbfm_sharded_fused import ShardedFusedStreamer
from tpu_sdr_torch.utils.design import WbfmConfig, split_bf16_sum


def poly_from_matrix(V, up: int, down: int) -> torch.Tensor:
    """(up, T) polyphase bank read back from a frame matrix V of
    ``make_aligned_poly_matrix`` (any frames-per-row packing): frame 0's
    column s holds ``h_poly[p_s, t]`` at row ``(T-1) + o_s - t``."""
    V = np.asarray(V, dtype=np.float32)
    Tm1 = V.shape[0] - down * (V.shape[1] // up)
    h_poly = np.zeros((up, Tm1 + 1), dtype=np.float32)
    for s in range(up):
        o, p = (s * down) // up, (s * down) % up
        h_poly[p] = V[Tm1 + o - np.arange(Tm1 + 1), s]
    return torch.from_numpy(h_poly)


def params_from_jax(w_hi, w_lo, v, spec: FusedWbfmSpec, *,
                    device: str | torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``pallas_fm.make_kernel_params`` output -> the port's (taps, h_poly)."""
    taps = effective_taps(w_hi, w_lo, spec.num_taps)
    h_poly = poly_from_matrix(v, spec.up, spec.down)
    return taps.to(device), h_poly.to(device)


def state_from_jax(carry, resamp_hist, phase, *, device: str | torch.device):
    """A ``PallasWbfmStreamer``'s (state, resamp_hist, phase) -> the port's
    (carry, resampler history, phase); a ``PallasWbfmBatchStreamer``'s
    (states (S, 4, 128), resamp_hists (S, T-1), phases (S,)) -> the
    ``FusedWbfmBatchStreamer``'s, the phases a list."""
    phase = np.asarray(phase)
    return (torch.from_numpy(np.array(carry, dtype=np.float32)).to(device),
            torch.from_numpy(np.array(resamp_hist, dtype=np.float32)).to(device),
            int(phase) if phase.ndim == 0 else [int(p) for p in phase])


def state_to_jax(carry: torch.Tensor, resamp_hist: torch.Tensor, phase):
    """The port's fused state (one station or a batch) -> numpy (state,
    resamp_hist, phase) for a ``PallasWbfmStreamer`` (or the batch's, the
    phases an int32 array)."""
    return (_np(carry), _np(resamp_hist),
            int(phase) if isinstance(phase, int)
            else np.asarray(phase, dtype=np.int32))


def wbfm_state_from_jax(state, *, device: str | torch.device) -> M.WbfmState:
    """A JAX float-chain ``WbfmState`` (all six carries) -> the port's; the
    resampler's ``t0`` and the boxcar accumulator become ints.  A stacked
    (station batch) state keeps its station axis; its stations must share
    the fs/4 phase, ``t0`` and the accumulator, as the JAX batch's shared
    count assumes."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return M.WbfmState(
        _shared_int(state.rot.phase, "fs/4 phase"),
        F.FirState(t(state.fir.hist_re), t(state.fir.hist_im)),
        F.QuadState(t(state.quad.pre_re), t(state.quad.pre_im)),
        F.ResampleState(t(state.resamp.hist),
                        _shared_int(state.resamp.t0, "t0")),
        F.BoxcarResampleState(t(state.box_resamp.now),
                              _shared_int(state.box_resamp.acc, "acc")),
        F.DeemphState(t(state.deemph.y_prev)))


def _shared_int(x, what: str) -> int:
    """One int from a JAX scalar, or from the equal entries of a stacked
    station batch."""
    v = np.asarray(x).reshape(-1)
    if v.size == 0 or (v != v[0]).any():
        raise ValueError(f"the stations' {what} differ: {v.tolist()}")
    return int(v[0])


def wbfm_state_to_jax(state: M.WbfmState, stations: int | None = None):
    """The port's float-chain state -> numpy nested as the JAX
    ``WbfmState``'s fields: ((phase,), (hist_re, hist_im), (pre_re,
    pre_im), (hist, t0), (now, acc), (y_prev,)), the ints as int32 (one a
    station when ``stations`` is given)."""
    def n(x):
        return _np(x)

    def i(v):
        return np.int32(v) if stations is None else np.full(stations, v,
                                                             np.int32)

    return ((i(state.rot),), (n(state.fir.hist_re), n(state.fir.hist_im)),
            (n(state.quad.pre_re), n(state.quad.pre_im)),
            (n(state.resamp.hist), i(state.resamp.t0)),
            (n(state.box_resamp.now), i(state.box_resamp.acc)),
            (n(state.deemph.y_prev),))


def exact_state_from_jax(state, *, device: str | torch.device
                         ) -> WE.WbfmExactState:
    """A JAX ``WbfmExactState`` -> the port's (0-d int32 tensors)."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)

    return WE.WbfmExactState(
        X.BoxcarState(*(t(x) for x in state.boxcar)),
        X.DiscriminatorState(*(t(x) for x in state.discr)),
        X.ResamplerState(*(t(x) for x in state.resamp)))


def exact_state_to_jax(state: WE.WbfmExactState):
    """The port's exact-chain state -> numpy int32 nested as the JAX
    ``WbfmExactState``'s fields."""
    return tuple(tuple(_np(x) for x in part) for part in state)


def _np(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array of its own."""
    return x.detach().to("cpu", copy=True).numpy()


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def pfb_matrix_from_conv_weights(W) -> torch.Tensor:
    """M2 = [M_re | M_im] (rows*K, 2K) read back from the XLA front's conv
    weights (``channelizer.pfb_conv_weights``: W[k, p, rows-1-t] =
    M_re[t*K + p, k], W[K + k, p, rows-1-t] = M_im[t*K + p, k])."""
    W = np.asarray(W, dtype=np.float32)
    K, rows = W.shape[0] // 2, W.shape[2]
    t_first = W[:, :K, ::-1].transpose(2, 1, 0)  # (t, p, [re k | im k])
    return torch.from_numpy(np.ascontiguousarray(t_first).reshape(rows * K,
                                                                  2 * K))


def wideband_params_from_jax(params, m2_hi, m2_lo, config: WB.WidebandConfig,
                             *, device: str | torch.device) -> WB.WidebandParams:
    """A JAX ``WidebandParams`` and the Pallas front's ``(M2_hi, M2_lo)``
    -> the port's ``WidebandParams`` for ``config`` (K3's tap table from
    the JAX ``h_poly``, its plain version's M2 from the pair)."""
    port = WB.make_params(config, device=device)
    port.h_poly = _tensor(params.h_poly, device)
    port.kernel_taps = FC.kernel_taps(np.asarray(params.h_poly)).to(device)
    port.pfb_m2 = pfb_matrix_from_conv_weights(params.pfb_W).to(device)
    port.kernel_m2 = split_bf16_sum(m2_hi, m2_lo).to(device)
    port.resamp_V = _tensor(params.resamp_V, device)
    return port


def pfb_carry_from_jax(carry, *, device: str | torch.device) -> torch.Tensor:
    """The Pallas front's (2H, K) carry -> the port's K3 carry."""
    return _tensor(carry, device)


def pfb_carry_to_jax(carry: torch.Tensor) -> np.ndarray:
    return _np(carry)


def wideband_state_from_jax(state, *, device: str | torch.device
                            ) -> WB.WidebandState:
    """A JAX ``WidebandState`` (XLA ``PfbState`` and the stacked
    discriminator and resampler states) -> the port's."""
    return WB.WidebandState(
        chan.PfbState(_tensor(state.pfb.hist_re, device),
                      _tensor(state.pfb.hist_im, device)),
        F.QuadState(_tensor(state.quad.pre_re, device),
                    _tensor(state.quad.pre_im, device)),
        F.AlignedResampleState(_tensor(state.resamp.hist, device)))


def wideband_state_to_jax(state: WB.WidebandState):
    """The port's ``WidebandState`` -> numpy arrays nested as the JAX
    ``WidebandState``'s fields: ((hist_re, hist_im), (pre_re, pre_im),
    (hist,))."""
    def n(x):
        return _np(x)

    return ((n(state.pfb.hist_re), n(state.pfb.hist_im)),
            (n(state.quad.pre_re), n(state.quad.pre_im)),
            (n(state.resamp.hist),))


def config_from_jax(config) -> WbfmConfig:
    """A JAX ``WbfmConfig`` -> the port's (the same fields)."""
    return WbfmConfig(**{f.name: getattr(config, f.name)
                         for f in dataclasses.fields(WbfmConfig)})


def sharded_carry_from_jax(kernel_edge, rs_edge, *,
                           device: str | torch.device
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX fused sharded chain's ``(kernel_edge, rs_edge)`` -> the
    port's, on ``device``."""
    return _tensor(kernel_edge, device), _tensor(rs_edge, device)


def sharded_carry_to_jax(kernel_edge: torch.Tensor, rs_edge: torch.Tensor
                         ) -> tuple[np.ndarray, np.ndarray]:
    return _np(kernel_edge), _np(rs_edge)


def xla_carry_from_jax(carry, *, device: str | torch.device
                       ) -> XlaStreamCarry:
    """A JAX ``XlaStreamCarry`` -> the port's, on ``device``."""
    return XlaStreamCarry(*(_tensor(c, device) for c in carry))


def xla_carry_to_jax(carry: XlaStreamCarry) -> tuple[np.ndarray, ...]:
    """The port's ``XlaStreamCarry`` -> numpy in the JAX field order."""
    return tuple(_np(c) for c in carry)


def sharded_streamer_from_jax(streamer, mesh: Mesh) -> ShardedFusedStreamer:
    """A mid-stream JAX ``ShardedPallasStreamer`` -> a
    ``ShardedFusedStreamer`` on ``mesh`` that continues its stream.  The
    JAX streamer's blocks must have been in-kernel (``rot_impl=
    'broadcast'``) or host rotated: both leave the same carries."""
    states = np.asarray(streamer.states)
    port = ShardedFusedStreamer(mesh, states.shape[0],
                                config_from_jax(streamer.config))
    port.states, port.resamp_hists = sharded_carry_from_jax(
        states, streamer.resamp_hists, device=mesh.home)
    return port


def sharded_streamer_to_jax(streamer: ShardedFusedStreamer
                            ) -> tuple[np.ndarray, np.ndarray]:
    """A ``ShardedFusedStreamer``'s ``(states, resamp_hists)`` as numpy, to
    assign to a ``ShardedPallasStreamer`` of the same stations."""
    return sharded_carry_to_jax(streamer.states, streamer.resamp_hists)


# ---- the stereo decoder, RDS, the narrowband modes and the PSD ------------

def _decim_weights(params) -> torch.Tensor:
    """A JAX front's decimator (``WbfmParams``, ``MultimodeParams``) as the
    f32 weights it applies: the split-bf16 pair as ``255 * (W_hi + W_lo)``
    (the TPU scales the frames by 255 before its bf16 matmuls), else the
    f32 ``decim_W``."""
    if params.decim_W_split is not None:
        return 255.0 * split_bf16_sum(*params.decim_W_split)
    return _tensor(params.decim_W, "cpu")


def _fir(state, device) -> F.FirState:
    return F.FirState(_tensor(state.hist_re, device),
                      _tensor(state.hist_im, device))


def _fir_to_jax(state: F.FirState):
    return (_np(state.hist_re), _np(state.hist_im))


def stereo_params_from_jax(params, config: ST.StereoConfig, *,
                           device: str | torch.device) -> ST.StereoParams:
    """A JAX ``StereoParams`` -> the port's for ``config``: the front's
    decimator as its effective f32 weights, its resampler banks and the
    four banded filters."""
    port = ST.make_params(config, device=device)
    port.front.decim_W = _decim_weights(params.front).to(device)
    port.front.resamp_poly = _tensor(params.front.resamp_poly, device)
    port.front.resamp_V = _tensor(params.front.resamp_V, device)
    port.front.box_V = _tensor(params.front.box_V, device)
    for name in ("W_s", "W_p", "W_c", "W_d"):
        setattr(port, name, _tensor(getattr(params, name), device))
    return port


def stereo_state_from_jax(state, *, device: str | torch.device
                          ) -> ST.StereoState:
    """A JAX ``StereoState`` (all eleven carries) -> the port's."""
    return ST.StereoState(
        wbfm_state_from_jax(state.front, device=device),
        *(_fir(s, device) for s in (state.lpf_s, state.bpf_p, state.bpf_c,
                                    state.lpf_d)),
        F.DelayState(_tensor(state.dly_y.hist, device)),
        F.DelayState(_tensor(state.dly_s.hist, device)),
        F.DeemphState(_tensor(state.de_l.y_prev, device)),
        F.DeemphState(_tensor(state.de_r.y_prev, device)),
        F.AlignedResampleState(_tensor(state.rs_l.hist, device)),
        F.AlignedResampleState(_tensor(state.rs_r.hist, device)))


def stereo_state_to_jax(state: ST.StereoState):
    """The port's ``StereoState`` -> numpy nested as the JAX one's fields."""
    def n(x):
        return _np(x)

    return (wbfm_state_to_jax(state.front),
            *(_fir_to_jax(s) for s in (state.lpf_s, state.bpf_p, state.bpf_c,
                                       state.lpf_d)),
            (n(state.dly_y.hist),), (n(state.dly_s.hist),),
            (n(state.de_l.y_prev),), (n(state.de_r.y_prev),),
            (n(state.rs_l.hist),), (n(state.rs_r.hist),))


def rds_params_from_jax(params, config: R.RdsConfig, *,
                        device: str | torch.device) -> R.RdsParams:
    """A JAX ``RdsParams`` -> the port's for ``config``."""
    port = R.make_params(config, device=device)
    for name in ("W_p", "W_s", "W_lp", "resamp_V"):
        setattr(port, name, _tensor(getattr(params, name), device))
    return port


def rds_state_from_jax(state, *, device: str | torch.device) -> R.RdsState:
    return R.RdsState(_fir(state.bpf_p, device), _fir(state.bpf_s, device),
                      _fir(state.lpf, device),
                      F.AlignedResampleState(_tensor(state.resamp.hist,
                                                     device)))


def rds_state_to_jax(state: R.RdsState):
    return (_fir_to_jax(state.bpf_p), _fir_to_jax(state.bpf_s),
            _fir_to_jax(state.lpf), (_np(state.resamp.hist),))


def multimode_params_from_jax(params, config: MM.MultimodeConfig, *,
                              device: str | torch.device
                              ) -> MM.MultimodeParams:
    """A JAX ``MultimodeParams`` -> the port's for ``config``: the
    split-bf16 decimator the JAX front always runs, as its effective f32
    weights ``255 * (W_hi + W_lo)``."""
    port = MM.make_params(config, device=device)
    port.decim_W = _decim_weights(params).to(device)
    port.chan_W = _tensor(params.chan_W, device)
    port.resamp_V = _tensor(params.resamp_V, device)
    return port


def multimode_state_from_jax(state, *, device: str | torch.device
                             ) -> MM.MultimodeState:
    """A JAX ``MultimodeState`` (all nine carries) -> the port's; the fs/4
    phase and the SSB phase indices become ints."""
    return MM.MultimodeState(
        int(np.asarray(state.rot.phase)), _fir(state.fir, device),
        _fir(state.chan, device),
        F.QuadState(_tensor(state.quad.pre_re, device),
                    _tensor(state.quad.pre_im, device)),
        F.AlignedResampleState(_tensor(state.resamp.hist, device)),
        F.AlignedResampleState(_tensor(state.resamp_q.hist, device)),
        int(np.asarray(state.ssb_phase)), int(np.asarray(state.ssb_phase2)),
        F.DeemphState(_tensor(state.deemph.y_prev, device)))


def multimode_state_to_jax(state: MM.MultimodeState):
    """The port's ``MultimodeState`` -> numpy nested as the JAX one's
    fields, the ints as int32."""
    def n(x):
        return _np(x)

    return ((np.int32(state.rot),), _fir_to_jax(state.fir),
            _fir_to_jax(state.chan), (n(state.quad.pre_re),
                                      n(state.quad.pre_im)),
            (n(state.resamp.hist),), (n(state.resamp_q.hist),),
            np.int32(state.ssb_phase), np.int32(state.ssb_phase2),
            (n(state.deemph.y_prev),))


def psd_state_from_jax(state, *, device: str | torch.device) -> SP.PsdState:
    """A JAX ``PsdState`` -> the port's (the segment count an int)."""
    return SP.PsdState(_tensor(state.acc, device), int(np.asarray(state.count)))


def psd_state_to_jax(state: SP.PsdState) -> tuple[np.ndarray, np.float32]:
    return _np(state.acc), np.float32(state.count)
