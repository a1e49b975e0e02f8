"""The graphed streamers (``tpu_sdr_torch.utils.graphs``) on the CPU.

CUDA graphs do not exist on the CPU: there each streamer runs its step
eagerly on the same static input, carry and output buffers that its graphs
replay over on the card (the static-buffer form).  For every graphed
streamer, over 64 uneven reads (seeded numpy lengths that leave residuals,
read nothing now and then, and change the key), the static-buffer form
must be bit-equal to the eager streamer loop the port ran before (the
block functions called one read at a time), ``graphs.disabled()`` must
give the same bits, and the audio must match the JAX streamer on the same
reads at the bar the other ``test_torch_*`` files hold it to: >= 100 dB
(the narrowband modes with the JAX weights converted and their first 32
samples left out, as ``test_torch_multimode.py`` does), bit-equal for the
exact chain (``test_torch_exact.py``'s bar) and within 0.01 dB for the
PSD (``test_torch_spectrum.py``'s).  Also here:
checkpoint and resume through the static buffers, the float chain's keys
at the CLI's 262,144-byte reads, the helper's own rules (eviction, carries
assigned from outside, the SSB mixer's index as a tensor), and a soak of
the port mirroring ``tests/test_soak.py``.  The twins on the card, graphed
against ``graphs.disabled()``, are in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_sdr.models import multimode as JM
from tpu_sdr.models import rds as JR
from tpu_sdr.models import wbfm as JW
from tpu_sdr.models import wbfm_batched as JB
from tpu_sdr.models import wbfm_exact as JE
from tpu_sdr.models import wbfm_stereo as JS
from tpu_sdr.models import wbfm_wideband as JWB
from tpu_sdr.ops import pallas_channelizer as JPC
from tpu_sdr.ops import pallas_fm
from tpu_sdr.ops import spectrum as JSP
from tpu_sdr_torch import convert
from tpu_sdr_torch.models import multimode as TM
from tpu_sdr_torch.models import rds as TR
from tpu_sdr_torch.models import wbfm as TW
from tpu_sdr_torch.models import wbfm_batched as TB
from tpu_sdr_torch.models import wbfm_exact as TE
from tpu_sdr_torch.models import wbfm_stereo as TS
from tpu_sdr_torch.models import wbfm_wideband as WB
from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.ops import spectrum as SP
from tpu_sdr_torch.stream import checkpoint as C
from tpu_sdr_torch.utils import design, graphs, synth
from tpu_sdr_torch.utils.design import WbfmConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
READS = 64
CHUNK = FF.default_spec().chunk_bytes  # 130,560
WB_CONFIG = dict(num_channels=64, channels=(3, 60))
PSD_DB_TOL = 0.01  # tests/test_torch_spectrum.py's bar
PSD_FFT = 256
PFB = (64, 8, 64)  # K, taps a branch, frames a chunk: 8,192-byte chunks


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _lengths(mean: int, jitter: int, step: int, seed: int,
             long: int = 0) -> np.ndarray:
    """READS seeded read lengths, multiples of ``step``, within ``jitter``
    of ``mean``; every tenth ``long`` (two kernel chunks: another key)."""
    rng = np.random.default_rng(seed)
    n = (mean + rng.integers(-jitter, jitter + 1, READS)) // step * step
    if long:
        n[5::10] = long
    return n


@dataclasses.dataclass
class Case:
    """A graphed streamer, its input and reads, the eager loop it replaces
    and its JAX counterpart."""

    make: object          # device -> port streamer
    data: np.ndarray      # the capture (or multiplex), time on the last axis
    lengths: np.ndarray   # the reads' lengths along that axis
    feed: object          # (streamer, read) -> tuple of numpy outputs
    eager: object         # () -> feed-like callable: the pre-graph loop
    jax: object = None    # () -> feed-like callable, or (it, a hook that
    #                       puts the JAX weights into a port streamer)
    skip: int = 0         # leading samples the JAX comparison leaves out
    bar: str = "snr"      # against JAX: "snr" >= 100 dB, "equal" bit for
    #                       bit, "db" within PSD_DB_TOL

    def reads(self):
        at = 0
        for n in self.lengths:
            yield self.data[..., at:at + n]
            at += n


class EagerLoop:
    """The streamers' demodulate as the port ran it before its steps were
    graphed: the residual cut, one call of the block function on a tensor
    of the usable bytes, each output copied to the host on its own."""

    def __init__(self, quantum: int, block_fn, state, empty):
        self.quantum, self.block_fn, self.state = quantum, block_fn, state
        self.empty = empty
        self.pending = None

    def __call__(self, buf):
        data = buf if self.pending is None else np.concatenate(
            [self.pending, buf], axis=-1)
        usable = data.shape[-1] - data.shape[-1] % self.quantum
        self.pending = data[..., usable:]
        if usable == 0:
            return self.empty
        block = torch.from_numpy(np.ascontiguousarray(data[..., :usable]))
        outs, self.state = self.block_fn(block, self.state)
        return tuple(o.cpu().numpy() for o in outs)


def _fused_case():
    data = np.asarray(synth.synth_wbfm_u8(3_000_000, noise_std=0.02,
                                          seed=1)[0], np.uint8)

    def eager():
        taps, h_poly = FF.make_kernel_params(device=CPU)
        spec = FF.default_spec()

        def fn(block, st):
            carry, hist, phase = st
            a, carry, hist = FF.demodulate_fused(block, phase, carry, hist,
                                                 taps, h_poly, spec)
            return (a,), (carry, hist, (phase + block.shape[-1] // 2) % 4)

        return EagerLoop(CHUNK, fn, (FF.init_carry(CPU), torch.zeros(47), 0),
                         (np.zeros(0, np.float32),))

    def jax():
        s = pallas_fm.PallasWbfmStreamer(interpret=True, rot_impl="broadcast")
        return lambda b: (s.demodulate(b),)

    return Case(lambda d: FF.FusedWbfmStreamer(device=d), data,
                _lengths(50_000, 48_000, 2, 2, long=2 * CHUNK + 9_000),
                lambda s, b: (s.demodulate(b),), eager, jax)


def _fused_batch_case(phases):
    """The batch at a phase a station (K1 reads the streamer's phase
    tensor) or at one phase for all (the phase in the graph's key)."""
    rows = np.stack([np.asarray(synth.synth_wbfm_u8(
        2_600_000, noise_std=0.02, seed=s)[0], np.uint8) for s in (3, 4)])

    def make(d):
        s = FF.FusedWbfmBatchStreamer(2, device=d)
        s.phases = phases
        return s

    def eager():
        taps, h_poly = FF.make_kernel_params(device=CPU)
        spec = FF.default_spec()

        def fn(block, st):
            carries, hists, ph = st
            a, carries, hists = FF.demodulate_fused_batch(
                block, ph, carries, hists, taps, h_poly, spec)
            return (a,), (carries, hists,
                          [(p + block.shape[-1] // 2) % 4 for p in ph])

        return EagerLoop(CHUNK, fn, (FF.init_carry(CPU).repeat(2, 1, 1),
                                     torch.zeros(2, 47), list(phases)),
                         (np.zeros((2, 0), np.float32),))

    def jax():
        s = pallas_fm.PallasWbfmBatchStreamer(2, interpret=True,
                                              rot_impl="broadcast")
        s.phases = np.asarray(phases, np.int32)
        return lambda b: (s.demodulate(b),)

    return Case(make, rows, _lengths(50_000, 48_000, 2, 5,
                                     long=2 * CHUNK + 9_000),
                lambda s, b: (s.demodulate(b),), eager, jax)


def _float_case(**kw):
    data = np.asarray(synth.synth_wbfm_u8(130_000, noise_std=0.02,
                                          seed=6)[0], np.uint8)
    config = WbfmConfig(**kw)

    def feed(s, b):
        a = s.demodulate(b)
        return (a, s.last_mpx) if config.emit_mpx else (a,)

    def eager():
        params = TW.WbfmParams(config, CPU)

        def fn(block, st):
            *outs, st = TW.demodulate_block(block, st, params, config)
            return tuple(outs), st

        empty = (np.zeros(0, np.float32),) * (2 if config.emit_mpx else 1)
        return EagerLoop(2 * config.decim * config.resample_down, fn,
                         TW.init_state(config, CPU), empty)

    def jax():
        s = JW.WbfmStreamer(JW.WbfmConfig(mxu_precision="f32", **kw))
        return lambda b: feed(s, b)

    return Case(lambda d: TW.WbfmStreamer(config, device=d), data,
                _lengths(3_300, 700, 2, 7), feed, eager, jax)


def _float_batch_case():
    rows = np.stack([np.asarray(synth.synth_wbfm_u8(
        100_000, noise_std=0.02, seed=s)[0], np.uint8) for s in (8, 9)])
    config = WbfmConfig()

    def eager():
        params = TW.WbfmParams(config, CPU)

        def fn(block, st):
            a, st = TB.demodulate_batch(block, st, params, config)
            return (a,), st

        return EagerLoop(2 * config.decim, fn,
                         TB.init_batch_state(config, 2, CPU),
                         (np.zeros((2, 0), np.float32),))

    def jax():
        s = JB.WbfmBatchStreamer(2, JW.WbfmConfig(mxu_precision="f32"))
        return lambda b: (s.demodulate(b),)

    # lengths 3,000 +- 6: three block lengths (three JAX compiles), the
    # unaligned resampler's t0 moving through many keys
    return Case(lambda d: TB.WbfmBatchStreamer(2, config, device=d), rows,
                _lengths(3_000, 6, 2, 10), lambda s, b: (s.demodulate(b),),
                eager, jax)


def _wideband_case(fused: bool):
    u8, _ = synth.synth_multistation_u8(
        1_600_000, 64 * 170_000, station_freqs=[3 * 170_000, -4 * 170_000],
        audio_freqs=[1_000.0, 2_500.0], deviation=45_000.0)
    data = np.asarray(u8, np.uint8)
    config = WB.WidebandConfig(emit_mpx=True, **WB_CONFIG)

    def feed(s, b):
        return s.demodulate(b), s.last_mpx

    def eager():
        params = WB.make_params(config, device=CPU)
        spec = WB.fused_spec(config)

        def fn(block, st):
            state, carry = st
            if fused:
                a, mpx, carry, quad, hist = WB.demodulate_block_fused(
                    block, carry, state.quad, state.resamp.hist, params,
                    config, spec)
                state = WB.WidebandState(state.pfb, quad,
                                         state.resamp._replace(hist=hist))
            else:
                a, mpx, state = WB.demodulate_block(block, state, params,
                                                    config)
            return (a, mpx), (state, carry)

        quantum = spec.chunk_bytes if fused else 2 * 64 * 85
        empty = (np.zeros((2, 0), np.float32),) * 2
        from tpu_sdr_torch.ops import fused_channelizer as FC
        return EagerLoop(quantum, fn, (WB.init_state(config, params),
                                       FC.init_carry(spec, CPU)), empty)

    def jax():
        s = JWB.WidebandStreamer(JWB.WidebandConfig(emit_mpx=True,
                                                    **WB_CONFIG),
                                 use_pallas=fused, interpret=True)
        return lambda b: feed(s, b)

    return Case(lambda d: WB.WidebandStreamer(config, use_fused=fused,
                                              device=d),
                data, _lengths(30_000, 28_000, 2, 11, long=180_000), feed,
                eager, jax)


def _stereo_case():
    u8, _, _ = synth.synth_wbfm_stereo_u8(80_000, capture_rate=1_020_000)
    data = np.asarray(u8, np.uint8)
    config = TS.StereoConfig(deemphasis_tau=75e-6, emit_mpx=True)

    def feed(s, b):
        return s.demodulate(b), s.last_mpx

    def eager():
        params = TS.make_params(config, device=CPU)

        def fn(block, st):
            a, mpx, st = TS.demodulate_block(block, st, params, config)
            return (a, mpx), st

        return EagerLoop(510, fn, TS.init_state(config, CPU),
                         (np.zeros((2, 0), np.float32),
                          np.zeros(0, np.float32)))

    def jax():
        s = JS.WbfmStereoStreamer(JS.StereoConfig(
            base=JW.WbfmConfig(filter_mode="fir", decim=3, rate_out=340_000,
                               mxu_precision="f32"),
            deemphasis_tau=75e-6, emit_mpx=True))
        return lambda b: feed(s, b)

    return Case(lambda d: TS.WbfmStereoStreamer(config, device=d), data,
                _lengths(2_100, 500, 2, 12), feed, eager, jax)


def _mpx(n: int, seed: int = 13) -> np.ndarray:
    """A multiplex at 170 kHz: a tone, the 19 kHz pilot and a seeded BPSK
    at 57 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 170_000
    bits = rng.integers(0, 2, int(n / 170_000 * 1187.5) + 2)
    sign = np.where(bits[(t * 1187.5).astype(int)] == 0, 1.0, -1.0)
    theta = 2 * np.pi * 19_000.0 * t
    return (0.4 * np.sin(2 * np.pi * 1_000.0 * t) + 0.1 * np.cos(theta)
            + 0.06 * sign * np.cos(3 * theta)).astype(np.float32)


def _rds_case():
    config = TR.RdsConfig()

    def feed(s, b):
        return s.process(b), np.float32(s.pilot_amp)

    def eager():
        params = TR.make_params(config, device=CPU)

        def fn(block, st):
            b152, amp, st = TR.baseband_block(block, st, params, config)
            return (b152, amp), st

        return EagerLoop(85, fn, TR.init_state(config, CPU), None)

    def jax():
        s = JR.RdsReceiver()
        return lambda b: (s.process(b),)

    return Case(lambda d: TR.RdsReceiver(config, device=d), _mpx(170_000),
                _lengths(2_200, 500, 1, 14), feed, eager, jax)


def _multimode_case(mode: str, **kw):
    data = np.asarray(synth.synth_wbfm_u8(130_000, deviation=5_000.0,
                                          noise_std=0.02, seed=15)[0],
                      np.uint8)
    config = TM.MultimodeConfig(mode=mode, **kw)

    def feed(s, b):
        return s.demodulate(b), np.float32(s.last_power or 0.0)

    def eager():
        params = TM.make_params(config, device=CPU)

        def fn(block, st):
            a, power, st = TM.demodulate_block(block, st, params, config)
            return (a, power), st

        return EagerLoop(1020, fn, TM.init_state(config, CPU), None)

    def jax():
        s = JM.MultimodeStreamer(JM.MultimodeConfig(mode=mode, **kw))

        def port_weights(port):
            port.params = convert.multimode_params_from_jax(s.params, config,
                                                            device=CPU)

        return (lambda b: (s.demodulate(b),)), port_weights

    return Case(lambda d: TM.MultimodeStreamer(config, device=d), data,
                _lengths(3_300, 700, 2, 16), feed, eager, jax, skip=32)


def _exact_case():
    data = np.asarray(synth.synth_wbfm_u8(130_000, noise_std=0.02,
                                          seed=21)[0], np.uint8)

    def eager():
        def fn(block, st):
            audio, count, st = TE.demodulate_block(block, st,
                                                   TE.WbfmExactConfig())
            return (audio[:int(count)],), st

        return EagerLoop(8, fn, TE.init_state(CPU), None)

    def jax():
        s = JE.WbfmExactStreamer()
        return lambda b: (s.demodulate(b),)

    return Case(lambda d: TE.WbfmExactStreamer(device=d), data,
                _lengths(3_300, 700, 8, 22), lambda s, b: (s.demodulate(b),),
                eager, jax, bar="equal")


def _psd_feed(s, b):
    """The bins after a read that added segments, else nothing."""
    before = s.segments
    s.accumulate(b)
    return (s.finalize_db(),) if s.segments > before else (np.zeros(0),)


def _psd_case():
    data = np.asarray(synth.synth_wbfm_u8(40_000, noise_std=0.02,
                                          seed=23)[0], np.uint8)

    def eager():
        window = SP.hann(PSD_FFT)
        w = torch.from_numpy(window)

        def fn(block, st):
            st = SP.psd_accumulate(block, st, w, PSD_FFT)
            return (torch.from_numpy(SP.psd_db(st, window)),), st

        return EagerLoop(2 * PSD_FFT, fn, SP.psd_init(PSD_FFT, CPU),
                         (np.zeros(0),))

    def jax():
        s = JSP.PsdStreamer(PSD_FFT)
        return lambda b: _psd_feed(s, b)

    return Case(lambda d: SP.PsdStreamer(PSD_FFT, device=d), data,
                _lengths(1_000, 900, 2, 24), _psd_feed, eager, jax, bar="db")


def _pfb_feed(s, b):
    """K3's (m, K) frames, time on the last axis."""
    return tuple(y.T for y in s.channelize(b))


def _pfb_case():
    rng = np.random.default_rng(25)
    data = rng.integers(0, 256, 64 * 11_000, dtype=np.uint8)
    chunk = FC.default_spec(*PFB).chunk_bytes

    def eager():
        spec = FC.default_spec(*PFB)
        taps = FC.kernel_taps(design.design_pfb(*PFB[:2]))

        def fn(block, carry):
            y_re, y_im, carry = FC.channelize(block, carry, taps, spec)
            return (y_re.T, y_im.T), carry

        return EagerLoop(chunk, fn, FC.init_carry(spec, CPU),
                         (np.zeros((64, 0), np.float32),) * 2)

    def jax():
        s = JPC.PallasPfbStreamer(*PFB, interpret=True)
        return lambda b: tuple(np.asarray(y).T for y in s.channelize(b))

    return Case(lambda d: FC.FusedPfbStreamer(*PFB, device=d), data,
                _lengths(10_000, 9_000, 2, 26, long=3 * chunk + 100),
                _pfb_feed, eager, jax)


CASES = {
    "fused": _fused_case,
    "fused_batch": lambda: _fused_batch_case([0, 3]),
    "fused_batch_one_phase": lambda: _fused_batch_case([2, 2]),
    "fir": lambda: _float_case(),
    "fir_deemph_mpx": lambda: _float_case(deemphasis_tau=75e-6,
                                          emit_mpx=True),
    "boxcar": lambda: _float_case(filter_mode="boxcar"),
    "boxcar_deemph": lambda: _float_case(filter_mode="boxcar",
                                         deemphasis_tau=50e-6),
    "float_batch": _float_batch_case,
    "wideband_plain": lambda: _wideband_case(False),
    "wideband_fused": lambda: _wideband_case(True),
    "stereo": _stereo_case,
    "rds": _rds_case,
    "fm": lambda: _multimode_case("nbfm", deemphasis_tau=75e-6),
    "am": lambda: _multimode_case("am", squelch_db=-40.0),
    "usb": lambda: _multimode_case("usb", fine_tune_hz=120.0),
    "lsb": lambda: _multimode_case("lsb"),
    "exact": _exact_case,
    "psd": _psd_case,
    "pfb": _pfb_case,
}


def _run(feed, reads):
    return [feed(r) for r in reads]


@pytest.fixture(scope="module")
def cases():
    return {}


def _get(cases, name):
    """(case, the static-buffer form's outputs a read, its streamer)."""
    if name not in cases:
        case = CASES[name]()
        port = case.make(CPU)
        got = _run(lambda b: case.feed(port, b), case.reads())
        cases[name] = case, got, port
    return cases[name]


def _assert_same(exp, got, n=READS):
    assert len(exp) == len(got) == n
    for i, (e, g) in enumerate(zip(exp, got)):
        for x, y in zip(e, g):
            assert x.shape == y.shape and x.dtype == y.dtype, i
            assert np.array_equal(x, y), f"read {i}"


@pytest.mark.parametrize("name", list(CASES))
def test_static_buffer_form_equals_the_eager_streamer(cases, name):
    case, got, port = _get(cases, name)
    eager = case.eager()
    exp = []
    for r, g in zip(case.reads(), got):
        e = eager(r)
        # a read below one quantum leaves the streamer's measurement (the
        # narrowband power, the pilot amplitude) as it was
        exp.append(g if e is None else e[:len(g)])
    _assert_same(exp, got)
    # the reads crossed the residual path and changed key
    assert port.graphs.captures >= 2
    assert port.graphs.replays + port.graphs.captures == sum(
        1 for g in got if g[0].shape[-1])
    assert any(g[0].shape[-1] == 0 for g in got) or name not in (
        "fused", "fused_batch", "fused_batch_one_phase", "wideband_fused")


@pytest.mark.parametrize("name", list(CASES))
def test_disabled_gives_the_same_bits(cases, name):
    case, got, _ = _get(cases, name)
    port = case.make(CPU)
    with graphs.disabled():
        off = _run(lambda b: case.feed(port, b), case.reads())
    assert port.graphs.captures == port.graphs.replays == 0
    _assert_same(off, got)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(cases, name):
    case, got, _ = _get(cases, name)
    jax = case.jax()
    if isinstance(jax, tuple):  # the port again, on the JAX weights
        jax, port_weights = jax
        port = case.make(CPU)
        port_weights(port)
        got = _run(lambda b: case.feed(port, b), case.reads())
    exp = _run(jax, case.reads())
    for k in range(len(exp[0])):
        e = np.concatenate([x[k] for x in exp], axis=-1)
        g = np.concatenate([x[k] for x in got], axis=-1)
        assert e.shape == g.shape, (k, e.shape, g.shape)
        if case.bar == "equal":
            assert e.dtype == g.dtype and np.array_equal(e, g), name
        elif case.bar == "db":
            np.testing.assert_allclose(g, e, rtol=0, atol=PSD_DB_TOL)
        else:
            s = _snr_db(e[..., case.skip:], g[..., case.skip:])
            assert s >= 100.0, f"{name} output {k}: {s:.1f} dB"


@pytest.mark.parametrize("name", ["fused", "fir_deemph_mpx", "wideband_fused",
                                  "stereo", "usb", "rds", "exact", "psd",
                                  "pfb"])
def test_checkpoint_mid_stream_resumes_bit_equal(cases, name, tmp_path):
    """A checkpoint taken after read 30 (the carries are the static
    buffers then), loaded into a fresh streamer and into one whose steps
    already ran (its static buffers must take the loaded carries)."""
    case, got, _ = _get(cases, name)
    reads = list(case.reads())
    first = case.make(CPU)
    for r in reads[:30]:
        case.feed(first, r)
    path = str(tmp_path / "ck.npz")
    C.save_stream_state(path, first)
    for warm in (0, 5):
        resumed = case.make(CPU)
        for r in reads[:warm]:
            case.feed(resumed, r)
        C.load_stream_state(path, resumed)
        _assert_same(got[30:], [case.feed(resumed, r) for r in reads[30:]],
                     READS - 30)


def test_fused_batch_phases_live_on_the_device_and_checkpoint_as_a_list(
        tmp_path):
    s = FF.FusedWbfmBatchStreamer(3, device=CPU)
    s.phases = np.array([1, 2, 3])
    assert s.phases == [1, 2, 3]
    assert s._phases.dtype == torch.int32 and s._phases.device == CPU
    s.demodulate(np.zeros((3, CHUNK + 2), np.uint8))
    assert s.phases == [1, 2, 3]  # a chunk is a multiple of 4 samples
    path = str(tmp_path / "batch.npz")
    C.save_stream_state(path, s)
    saved = np.load(path)
    assert int(saved["phases.__n__"]) == 3  # one int a station, as before
    assert [int(saved[f"phases.{i}"]) for i in range(3)] == [1, 2, 3]
    fresh = FF.FusedWbfmBatchStreamer(3, device=CPU)
    C.load_stream_state(path, fresh)
    assert fresh.phases == [1, 2, 3] and torch.is_tensor(fresh._phases)
    # a checkpoint of the list form (no tensor anywhere) loads the same way
    np.savez(str(tmp_path / "old.npz"), **{k: saved[k] for k in saved.files})
    old = FF.FusedWbfmBatchStreamer(3, device=CPU)
    C.load_stream_state(str(tmp_path / "old.npz"), old)
    assert old.phases == [1, 2, 3]


@pytest.mark.parametrize("mode", ["fir", "boxcar"])
def test_float_chain_keys_at_the_cli_read(mode):
    """At 262,144-byte reads the float chain sees at most 4 keys: 257 or
    258 quanta of 1,020 bytes, at fs/4 phase 0 or 2."""
    data = np.asarray(synth.synth_wbfm_u8(12 * 131_072, seed=17)[0],
                      np.uint8)
    s = TW.WbfmStreamer(WbfmConfig(filter_mode=mode), device=CPU)
    for i in range(12):
        s.demodulate(data[i * 262_144:(i + 1) * 262_144])
    assert 2 <= len(s.graphs.keys) <= 4 and s.graphs.captures <= 4
    assert {k[0][0] for k in s.graphs.keys} <= {0, 2}
    assert {k[1][0][0][0] for k in s.graphs.keys} <= {257 * 1020, 258 * 1020}


def test_float_batch_keys_do_not_follow_the_resampler_index():
    """The station batch cuts blocks to 12 bytes, so at 262,144-byte reads
    the unaligned resampler's t0 moves every other read; it goes in as a
    device input, and the key holds only the output count: a few keys,
    most reads replays."""
    rows = np.stack([np.asarray(synth.synth_wbfm_u8(
        6 * 131_072, seed=s)[0], np.uint8) for s in (19, 20)])
    s = TB.WbfmBatchStreamer(2, device=CPU)
    for i in range(12):
        s.demodulate(rows[:, (i % 6) * 262_144:(i % 6 + 1) * 262_144])
    assert len({st for st, _, _ in s.graphs.keys}) <= 4
    assert s.graphs.captures <= 4 and s.graphs.replays >= 8


def test_fused_path_counts_no_launch_on_the_cpu():
    """On the CPU the wrappers take their plain versions, so the counters
    stay at 0 while every read with a chunk is one static-buffer step (the
    card's gate, one K1 and one K2 a replay, is in test_torch_cuda.py)."""
    data = np.asarray(synth.synth_wbfm_u8(4 * CHUNK // 2, seed=18)[0],
                      np.uint8)
    FF.reset_launch_counts()
    s = FF.FusedWbfmStreamer(device=CPU)
    for i in range(4):
        s.demodulate(data[i * CHUNK:(i + 1) * CHUNK])
    assert FF.LAUNCHES == {"fm_front": 0, "fm_resample": 0}
    assert (s.graphs.captures, s.graphs.replays) == (1, 3)


def _toy_step(static, inputs, carries):
    x, = inputs
    acc, = carries
    y = x * static + acc
    return [y, y.sum()], [y[-1:].clone()], static + 1


def test_helper_evicts_the_least_recently_used_key(monkeypatch):
    monkeypatch.setattr(graphs, "MAX_KEYS", 2)
    g = graphs.StepGraphs("toy", _toy_step, CPU)
    acc = torch.zeros(1)
    for k in (1, 2, 1, 3):
        _, (acc,), aux = g(k, [np.ones(4, np.float32)], [acc])
        assert aux == k + 1
    assert [key[0] for key in g.keys] == [1, 3]
    assert g.captures == 3 and g.replays == 1


def test_helper_outputs_do_not_alias_its_buffers():
    """Outputs come back as arrays of their own; carries assigned from
    outside are copied into the static ones, never written."""
    g = graphs.StepGraphs("toy", _toy_step, CPU)
    start = torch.full((1,), 5.0)
    (y, total), (acc,), _ = g(2, [np.arange(3, dtype=np.float32)], [start])
    np.testing.assert_array_equal(y, [5.0, 7.0, 9.0])
    assert total == np.float32(21.0) and acc is not start
    (y2, _), (acc2,), _ = g(2, [np.arange(3, dtype=np.float32)], [acc])
    assert acc2 is acc and float(acc) == 13.0
    np.testing.assert_array_equal(y, [5.0, 7.0, 9.0])  # not rewritten
    assert float(start) == 5.0
    (y3, _), _, _ = g(2, [np.zeros(3, np.float32)], [torch.zeros(1)])
    np.testing.assert_array_equal(y3, [0.0, 0.0, 0.0])


def _sum_step(static, inputs, carries):
    acc, = carries
    return [], [acc + inputs[0].sum()], static


def test_helper_no_output_form_moves_only_its_carries():
    g = graphs.StepGraphs("toy", _sum_step, CPU)
    acc = torch.zeros(())
    for k, x in enumerate((np.ones(3, np.float32), np.full(3, 2.0, np.float32),
                           np.ones(3, np.float32))):
        (acc,), aux = g.advance(k % 2, [x], [acc])
        assert aux == k % 2
    assert float(acc) == 12.0 and (g.captures, g.replays) == (2, 1)
    with graphs.disabled():
        (off,), _ = graphs.StepGraphs("toy", _sum_step, CPU).advance(
            0, [np.ones(3, np.float32)], [torch.zeros(())])
    assert float(off) == 3.0
    with pytest.raises(ValueError, match="one output form"):
        g((), [np.ones(3, np.float32)], [acc])
    with pytest.raises(ValueError, match="without outputs"):
        graphs.StepGraphs("toy", _toy_step, CPU).advance(
            1, [np.ones(2, np.float32)], [torch.zeros(1)])


def _wide_step(static, inputs, carries):
    """Two column views of one tensor, and a new carry."""
    x, = inputs
    both = torch.stack([x, x * static], dim=1)
    return [both[:, 0], both[:, 1]], [carries[0] + 1], None


def test_helper_device_outputs_are_the_callers():
    """A device output (and a new carry) kept across later calls does not
    change: each is a tensor of its own, a column view copied whole."""
    g = graphs.StepGraphs("toy", _wide_step, CPU)
    (a, b), (c,), _ = g.on_device(3.0, [np.arange(4, dtype=np.float32)],
                                  [torch.zeros(1)])
    kept = [t.clone() for t in (a, b, c)]
    c2 = c
    for k in range(3):
        (a2, b2), (c2,), _ = g.on_device(
            3.0, [np.full(4, k + 7.0, np.float32)], [c2])
    assert g.replays == 3
    for t, k in zip((a, b, c), kept):
        assert torch.equal(t, k)
    assert a.is_contiguous() and b.is_contiguous()
    assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    assert float(c2) == 4.0 and torch.equal(b2, torch.full((4,), 27.0))
    with graphs.disabled():
        (x, y), (z,), _ = graphs.StepGraphs("toy", _wide_step, CPU).on_device(
            3.0, [np.arange(4, dtype=np.float32)], [torch.zeros(1)])
    assert torch.equal(x, kept[0]) and torch.equal(y, kept[1])


def test_psd_streamer_reset_keeps_its_graphs():
    """A hop reset zeroes the sums and the count in place: the next hop
    replays the same key and gives what a new streamer gives."""
    data = np.asarray(synth.synth_wbfm_u8(8_192, seed=27)[0], np.uint8)
    s = SP.PsdStreamer(PSD_FFT, device=CPU)
    s.accumulate(data[:4_096])
    s.accumulate(data[4_096:8_192])
    s.reset()
    assert s.segments == 0 and float(s.state.acc.abs().sum()) == 0.0
    s.accumulate(data[8_192:12_288])
    fresh = SP.PsdStreamer(PSD_FFT, device=CPU)
    fresh.accumulate(data[8_192:12_288])
    np.testing.assert_array_equal(s.finalize_db(), fresh.finalize_db())
    assert (s.graphs.captures, s.graphs.replays) == (1, 2)


def test_rtl_power_scan_captures_once_a_key_not_once_a_hop(monkeypatch):
    """A scan of several hops over a fake dongle builds one PSD streamer,
    reset at each hop: one capture for its one block length, every other
    block a replay, and the rows those of a new streamer a hop (the JAX
    CLI's rows, as tests/test_torch_spectrum.py holds them)."""
    import contextlib
    import io

    from tpu_sdr_torch.apps import rtl_power as trp
    from tpu_sdr_torch.control import fake as tfake

    made = []

    class Recorded(SP.PsdStreamer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    rate = 1_020_000
    argv = ["-f", f"94000000:{94_000_000 + 3 * rate}:8k", "-s", str(rate),
            "-b", "2", "--torch-device", "cpu"]
    hops = len(trp.hop_centers(94_000_000, 94_000_000 + 3 * rate, rate,
                               trp.HOP_CROP))
    tfake.clear_fake_devices()
    tfake.register_fake_device(tfake.FakeDeviceSpec(
        serial="pw000002",
        source_factory=lambda: tfake.SynthFmSource(capture_rate=rate)))
    monkeypatch.setattr(SP, "PsdStreamer", Recorded)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert trp.main(argv) == 0
    finally:
        tfake.clear_fake_devices()
    assert hops >= 3 and len(out.getvalue().strip().splitlines()) == hops
    assert len(made) == 1
    s = made[0]
    assert len(s.graphs.keys) == s.graphs.captures == 1
    assert s.graphs.replays == 2 * hops - 1


def test_helper_checks_the_carry_count():
    def bad(static, inputs, carries):
        return [inputs[0]], [], None

    with pytest.raises(ValueError, match="toy"):
        graphs.StepGraphs("toy", bad, CPU)((), [np.ones(2)], [torch.zeros(1)])


def test_ssb_mixer_index_as_a_tensor_gives_the_same_bits():
    n, coef = 40_000, float(2 * np.pi * (-1_500.0 - 120) / 170_000)
    for phase in (0, 12_345, 169_999):
        a = TM._mixer(phase, n, coef, CPU)
        b = TM._mixer(torch.tensor(float(phase)), n, coef, CPU)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), phase


def test_state_split_and_join_round_trip():
    config = TS.StereoConfig()
    state = TS.init_state(config, CPU)
    ints, tensors = graphs.split_state(state)
    assert ints == (0, 0, 0)  # the front's phase, t0 and accumulator
    back = graphs.join_state(state, ints, tensors)
    assert type(back) is TS.StereoState and back == state


def _rows_step(static, inputs, carries):
    """``_toy_step`` over the last axis of rows."""
    x, = inputs
    acc, = carries
    y = x * static + acc
    return [y, y.sum()], [y[..., -1:].clone()], static + 1


@pytest.mark.parametrize("shape", [(12,), (2, 12)])
def test_helper_takes_an_input_in_pieces(shape):
    """A host input given as pieces (a residual and the head of a read)
    gives the outputs, carries and aux of one given their concatenation
    along the last axis, under the same single key, whatever the split;
    ``graphs.disabled()`` joins them."""
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    whole = graphs.StepGraphs("toy", _rows_step, CPU)
    split = graphs.StepGraphs("toy", _rows_step, CPU)
    acc_w = acc_s = torch.zeros(shape[:-1] + (1,))
    for cut in (0, 1, 5, 11, 12):
        (y, total), (acc_w,), aux = whole(2, [x], [acc_w])
        pieces = (x[..., :cut], x[..., cut:])
        (y2, total2), (acc_s,), aux2 = split(2, [pieces], [acc_s])
        assert np.array_equal(y, y2) and total == total2 and aux == aux2
        assert torch.equal(acc_w, acc_s), cut
        with graphs.disabled():
            (y3, _), _, _ = graphs.StepGraphs("toy", _rows_step, CPU)(
                2, [pieces], [torch.zeros(shape[:-1] + (1,))])
        (y4, _), _, _ = graphs.StepGraphs("toy", _rows_step, CPU)(
            2, [x], [torch.zeros(shape[:-1] + (1,))])
        assert np.array_equal(y3, y4), cut
    assert split.keys == whole.keys and len(split.keys) == 1
    assert (split.captures, split.replays) == (1, 4)


def test_split_residual_keeps_an_owned_tail():
    buf = np.frombuffer(bytes(range(250)), np.uint8)  # read-only
    pending = np.arange(7, dtype=np.uint8)
    pieces, rest, copied = graphs.split_residual(pending, buf, 16)
    assert pieces[0] is pending and np.shares_memory(pieces[1], buf)
    assert np.array_equal(np.concatenate(pieces), np.concatenate(
        [pending, buf])[:256])
    assert np.array_equal(rest, buf[249:]) and copied == 1
    assert rest.flags.owndata and rest.flags.writeable
    # a read under one quantum with the residual: one small join
    pieces, rest, copied = graphs.split_residual(rest, buf[:10], 16)
    assert pieces == () and copied == rest.nbytes == 11
    pieces, rest, copied = graphs.split_residual(rest, buf[:5], 16)
    assert len(pieces) == 2 and np.array_equal(np.concatenate(pieces), (
        np.concatenate([buf[249:], buf[:10], buf[:5]])))
    assert rest.shape == (0,) and copied == 0
    # a tensor read: moved to the device, joined there only where a
    # residual leads it (bytes counted on the CPU alone), the usable part
    # and the residual views of one tensor there
    t = torch.from_numpy(buf.copy())
    block, rest, copied = graphs.split_residual(rest, t, 16, CPU)
    assert block.data_ptr() == t.data_ptr() and copied == 0
    assert torch.equal(block, t[:240]) and torch.equal(rest, t[240:])
    block, rest, copied = graphs.split_residual(rest, t[:30], 16, CPU)
    assert torch.is_tensor(rest) and rest.device == CPU
    assert torch.equal(block, torch.cat([t[240:], t[:22]]))
    assert torch.equal(rest, t[22:30]) and copied == 40
    assert rest.untyped_storage().data_ptr() == \
        block.untyped_storage().data_ptr()
    assert graphs.width(block) == 32 and graphs.width(()) == 0
    # a numpy read after a tensor residual takes it over on the host
    pieces, rest, copied = graphs.split_residual(rest, buf[:8], 16)
    assert isinstance(pieces[0], np.ndarray) and graphs.width(pieces) == 16
    assert np.array_equal(np.concatenate(pieces), np.concatenate(
        [buf[22:30], buf[:8]])) and copied == 0 and rest.shape == (0,)


@pytest.mark.parametrize("tensor", [False, True])
def test_split_residual_refuses_rows_that_do_not_continue(tensor):
    """A batch read whose leading shape is not the residual's rows."""
    pending = np.zeros((4, 3), np.uint8)
    read = np.zeros((3, 100), np.uint8)
    with pytest.raises(ValueError, match="does not continue"):
        graphs.split_residual(pending, torch.from_numpy(read) if tensor
                              else read, 16)


def test_graph_runtime_imports_no_kernel_wrapper():
    """``utils.graphs`` reads the launch counters from the registry in
    ``kernels``, where each wrapper registers its own on import."""
    import ast
    import inspect
    from tpu_sdr_torch import kernels
    from tpu_sdr_torch.parallel import cuda_halo, shard_halo

    tree = ast.parse(inspect.getsource(graphs))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [f"{n.module}.{a.name}" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) for a in n.names]
    assert not [m for m in names if m.startswith(("tpu_sdr_torch.ops",
                                                  "tpu_sdr_torch.parallel"))]
    registered = [id(c) for c in kernels.LAUNCH_COUNTERS]
    for counter in (FF.LAUNCHES, FC.LAUNCHES, cuda_halo.LAUNCHES,
                    shard_halo.LAUNCHES):
        assert registered.count(id(counter)) == 1


def _wideband_stream(fused: bool):
    config = WB.WidebandConfig(emit_mpx=True, **WB_CONFIG)
    u8, _ = synth.synth_multistation_u8(
        200_000, 64 * 170_000, station_freqs=[3 * 170_000, -4 * 170_000],
        audio_freqs=[1_000.0, 2_500.0], deviation=45_000.0)

    def make():
        return WB.WidebandStreamer(config, use_fused=fused, device=CPU)

    def feed(s, b):
        return s.demodulate(b), s.last_mpx

    quantum = WB.fused_spec(config).chunk_bytes if fused else 2 * 64 * 85
    return make, np.asarray(u8, np.uint8), quantum, np.uint8, feed


def _rds_stream(fused=None):
    def feed(s, b):
        return s.process(b), np.float32(s.pilot_amp)

    return (lambda: TR.RdsReceiver(device=CPU), _mpx(40_000), 85,
            np.float32, feed)


def _fused_stream(stations=None):
    """The fused chain, one station, or a batch of ``stations`` rows, each
    its own seeded capture."""
    def capture(seed):
        return np.asarray(synth.synth_wbfm_u8(1_000_000, noise_std=0.02,
                                              seed=seed)[0], np.uint8)

    if stations is None:
        make, data = (lambda: FF.FusedWbfmStreamer(device=CPU)), capture(5)
    else:
        data = np.stack([capture(5 + k) for k in range(stations)])

        def make():
            return FF.FusedWbfmBatchStreamer(stations, device=CPU)

    return make, data, CHUNK, np.uint8, lambda s, b: (s.demodulate(b),)


def _float_stream(stations=None):
    """The float chain (fir), one station with its multiplex, or a batch
    of ``stations`` rows cut at ``2*decim`` bytes."""
    def capture(seed):
        return np.asarray(synth.synth_wbfm_u8(20_000, noise_std=0.02,
                                              seed=seed)[0], np.uint8)

    if stations is None:
        config = WbfmConfig(emit_mpx=True)

        def feed(s, b):
            return s.demodulate(b), s.last_mpx

        return (lambda: TW.WbfmStreamer(config, device=CPU), capture(6),
                2 * config.decim * config.resample_down, np.uint8, feed)
    config = WbfmConfig()
    return (lambda: TB.WbfmBatchStreamer(stations, config, device=CPU),
            np.stack([capture(8 + k) for k in range(stations)]),
            2 * config.decim, np.uint8, lambda s, b: (s.demodulate(b),))


def _stereo_stream():
    config = TS.StereoConfig(deemphasis_tau=75e-6, emit_mpx=True)
    u8, _, _ = synth.synth_wbfm_stereo_u8(12_000, capture_rate=1_020_000)

    def feed(s, b):
        return s.demodulate(b), s.last_mpx

    return (lambda: TS.WbfmStereoStreamer(config, device=CPU),
            np.asarray(u8, np.uint8),
            2 * config.base.decim * config.base.resample_down, np.uint8, feed)


def _multimode_stream():
    """USB: the SSB mixer's indices go in beside the block."""
    config = TM.MultimodeConfig(mode="usb", fine_tune_hz=120.0)
    data = np.asarray(synth.synth_wbfm_u8(20_000, deviation=5_000.0,
                                          noise_std=0.02, seed=15)[0],
                      np.uint8)

    def feed(s, b):
        return s.demodulate(b), np.float32(s.last_power or 0.0)

    return (lambda: TM.MultimodeStreamer(config, device=CPU), data,
            2 * config.decim * config.resample_down, np.uint8, feed)


def _psd_stream():
    data = np.asarray(synth.synth_wbfm_u8(10_000, noise_std=0.02,
                                          seed=23)[0], np.uint8)
    return (lambda: SP.PsdStreamer(PSD_FFT, device=CPU), data, 2 * PSD_FFT,
            np.uint8, _psd_feed)


def _pfb_stream():
    data = np.random.default_rng(25).integers(0, 256, 64 * 2_500,
                                              dtype=np.uint8)
    return (lambda: FC.FusedPfbStreamer(*PFB, device=CPU), data,
            FC.default_spec(*PFB).chunk_bytes, np.uint8, _pfb_feed)


STREAMS = {
    "wideband_fused": lambda: _wideband_stream(True),
    "wideband_plain": lambda: _wideband_stream(False),
    "rds": _rds_stream,
    "fused_one": _fused_stream,
    "fused_batch": lambda: _fused_stream(4),
    "float_one": _float_stream,
    "float_batch": lambda: _float_stream(3),
    "stereo": _stereo_stream,
    "multimode": _multimode_stream,
    "psd": _psd_stream,
    "pfb": _pfb_stream,
}


@pytest.mark.parametrize("residual", [0, 1000, "quantum-1", "short"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_residual_pieces_equal_the_blocks_joined(name, residual):
    """Reads that leave a residual of 0, 1,000 or one quantum less one
    sample, or are under a quantum, fed from one reused read-only buffer
    (a batch's rows strided in it): the outputs bit-equal to a second
    streamer fed, call for call, the usable blocks joined here, and the
    same graph keys, which follow the usable lengths and not how the
    residual and the read split them."""
    make, data, quantum, dtype, feed = STREAMS[name]()
    extra = {"quantum-1": quantum - 1, "short": 0}.get(residual, residual)
    reads = [quantum // 3] * 7 if residual == "short" else \
        [(1 + k % 2) * quantum + extra for k in range(6)]
    s, ref = make(), make()
    rows = data.shape[:-1]
    shape = rows + (max(reads),)
    scratch = bytearray(int(np.prod(shape)) * np.dtype(dtype).itemsize)
    pending = np.zeros(rows + (0,), dtype)
    at, with_output = 0, 0
    for n in reads:
        chunk = data[..., at:at + n]
        at += n
        n = chunk.shape[-1]  # the capture's last read may be short
        # the caller reuses its buffer
        np.frombuffer(scratch, dtype).reshape(shape)[..., :n] = chunk
        view = memoryview(scratch).toreadonly()
        got = feed(s, np.frombuffer(view, dtype).reshape(shape)[..., :n])
        del view
        joined = np.concatenate([pending, chunk], axis=-1)
        usable = joined.shape[-1] - joined.shape[-1] % quantum
        pending = joined[..., usable:]
        exp = feed(ref, joined[..., :usable])
        for x, y in zip(exp, got):
            assert x.dtype == y.dtype and np.array_equal(x, y), n
        with_output += usable > 0
        assert np.array_equal(s._pending, pending)
    assert with_output >= 2
    assert s.graphs.keys == ref.graphs.keys
    assert (s.graphs.captures, s.graphs.replays) == \
        (ref.graphs.captures, ref.graphs.replays)


@pytest.mark.parametrize("name", ["fused_one", "fused_batch"])
def test_tensor_and_numpy_reads_in_one_stream(name):
    """A fused streamer fed numpy reads and u8 tensors in turn, the
    residual passing from one kind to the other (and a tensor read with
    no residual, and a read under a chunk after each kind): the audio
    and the residual bit-equal to a twin fed the usable blocks joined."""
    make, data, quantum, _, feed = STREAMS[name]()
    reads = [(quantum + 1000, False), (quantum // 2, True),
             (2 * quantum - 7, False), (300, True), (quantum + 300, True),
             (5000, False), (quantum - 5, False), (2 * quantum, True),
             (quantum + 17, False)]
    assert sum(n for n, _ in reads) <= data.shape[-1]
    s, ref = make(), make()
    pending = data[..., :0]
    at = 0
    for n, tensor in reads:
        chunk = data[..., at:at + n]
        at += n
        got = feed(s, torch.from_numpy(chunk.copy()) if tensor else chunk)
        joined = np.concatenate([pending, chunk], axis=-1)
        usable = joined.shape[-1] - joined.shape[-1] % quantum
        pending = joined[..., usable:]
        exp = feed(ref, joined[..., :usable])
        for x, y in zip(exp, got):
            assert x.dtype == y.dtype and np.array_equal(x, y), n
        assert torch.is_tensor(s._pending) is tensor
        assert np.array_equal(np.asarray(s._pending), pending), n


def test_soak_wbfm_streamer_2000_blocks():
    """The port's twin of ``tests/test_soak.py``'s float-chain soak: 2,000
    blocks of 5,100 bytes (the residual path cycles, the key changes)
    through the graphed step == one-shot demodulation, and a clean tone
    at the end."""
    n_blocks, block_bytes = 2000, 5_100
    u8, _ = synth.synth_wbfm_u8(n_blocks * block_bytes // 2, noise_std=0.01)
    data = np.asarray(u8, np.uint8)
    streamed = TW.WbfmStreamer(device=CPU)
    got = np.concatenate([
        streamed.demodulate(data[i * block_bytes:(i + 1) * block_bytes])
        for i in range(n_blocks)])
    exp = TW.WbfmStreamer(device=CPU).demodulate(data)
    n = min(len(got), len(exp))
    assert n > 0.95 * len(exp)
    np.testing.assert_allclose(got[:n], exp[:n], rtol=1e-5, atol=1e-6)
    assert len(streamed.graphs.keys) <= 6
    tail = got[len(got) // 2:].astype(np.float64)
    assert synth.tone_snr(tail, 1_000.0, 32_000) > 40.0


def test_soak_exact_chain_1000_blocks():
    """The port's twin of ``tests/test_soak.py``'s integer-chain soak: the
    same split twice is bit-identical; against one shot only the samples
    the block starts touch move, boundedly, and the rate does not drift."""
    n_blocks, block_bytes = 1000, 1_024
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, n_blocks * block_bytes, dtype=np.uint8)

    def stream():
        s = TE.WbfmExactStreamer(device=CPU)
        return np.concatenate(
            [s.demodulate(data[i * block_bytes:(i + 1) * block_bytes])
             for i in range(n_blocks)])

    got = stream()
    np.testing.assert_array_equal(got, stream())
    exp = TE.WbfmExactStreamer(device=CPU).demodulate(data)
    n = min(len(got), len(exp))
    assert n > 0.95 * len(exp)
    diff = np.abs(got[:n].astype(np.int32) - exp[:n].astype(np.int32))
    assert diff.max() <= 200, f"max {diff.max()}"
    assert (diff > 0).mean() < 0.10
    first, second = diff[: n // 2], diff[n // 2:]
    assert abs((second > 0).mean() - (first > 0).mean()) < 0.05
