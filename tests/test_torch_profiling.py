"""The port's profiling and cache utilities
(``homomorph_tpu_torch.utils.profiling``, ``homomorph_tpu_torch.utils.cache``)
on the CPU, mirroring ``tests/test_profiling.py``: ``Meter``, the H100 peaks
and speed-of-light models (the SM count and clock given by hand), ``trace``
with ``torch.profiler`` on the CPU, and ``enable_compilation_cache``."""

import json
import types
import os

import pytest
import torch

import homomorph_tpu_torch as ht
from homomorph_tpu_torch.utils import cache, profiling

H100 = dict(sms=132, mhz=1980.0)


class TestMeter:
    def test_counters_accumulate(self):
        m = profiling.Meter()
        with m.measure("encrypt", items=100):
            pass
        with m.measure("encrypt", items=50):
            pass
        with m.measure("decrypt", items=7):
            pass
        rep = m.report()
        assert rep["encrypt"]["calls"] == 2
        assert rep["encrypt"]["items"] == 150
        assert rep["decrypt"]["items"] == 7
        assert rep["encrypt"]["items_per_s"] is None or rep["encrypt"]["items_per_s"] > 0
        m.reset()
        assert m.report() == {}

    def test_measure_propagates_exceptions_but_records(self):
        m = profiling.Meter()
        with pytest.raises(RuntimeError):
            with m.measure("op"):
                raise RuntimeError("boom")
        assert m.report()["op"]["calls"] == 1


class TestPeaks:
    def test_h100_peaks_scale_with_sms_and_clock(self):
        peaks = profiling.chip_peaks(**H100)
        assert peaks["hbm_bw"] == 3.35e12 and peaks["int8_tc_ops"] == 1979e12
        assert peaks["int32_ops"] == 64 * 132 * 1980e6
        assert peaks["smem_bw"] == 128 * 132 * 1980e6
        half = profiling.chip_peaks(sms=66, mhz=1980.0)
        assert half["int32_ops"] * 2 == peaks["int32_ops"]

    def test_needs_a_card_or_the_numbers(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="card"):
            profiling.chip_peaks()


class TestSolModels:
    def test_models_positive_and_monotonic_in_batch(self):
        peaks = profiling.chip_peaks(**H100)
        for fn, args in [
            (profiling.clmul_sol, (9, 9)),
            (profiling.encrypt_sol, (128, 9)),
            (profiling.decrypt_sol, (9,)),
        ]:
            t1 = fn(1 << 10, *args, peaks=peaks)
            t2 = fn(1 << 12, *args, peaks=peaks)
            assert 0 < t1 < t2

    def test_clmul_model_scales_with_operands(self):
        peaks = profiling.chip_peaks(**H100)
        assert profiling.clmul_sol(1 << 10, 500, 17, peaks=peaks) > profiling.clmul_sol(
            1 << 10, 9, 9, peaks=peaks)

    def test_bounds_of_the_kernel_table(self):
        """The models reproduce the bounds that chip_smoke.py reports for the
        kernel table's first rows on an H100 at 132 SMs and 1,980 MHz."""
        peaks = profiling.chip_peaks(**H100)
        assert profiling.clmul_sol(2048, 9, 256, peaks=peaks) * 1e3 == pytest.approx(0.00850, rel=1e-3)
        assert profiling.encrypt_sol(1 << 21, 128, 9, peaks=peaks) * 1e3 == pytest.approx(
            0.03611, rel=1e-3)
        n = (1 << 21) * 4
        t1 = profiling.bound(n * 4, [(n * profiling.THREEFRY_ALU_OPS_PER_WORD, "int32_ops")], peaks)
        assert t1[0] * 1e3 == pytest.approx(0.02056, rel=1e-3) and t1[1] == "operations"

    def test_bound_names_what_binds(self):
        peaks = profiling.chip_peaks(**H100)
        assert profiling.bound(1e9, [(1.0, "int32_ops")], peaks)[1] == "bytes"
        assert profiling.bound(4.0, [(1e12, "int32_ops")], peaks)[1] == "operations"

    @pytest.mark.parametrize("La,Lb", [(5, 5), (9, 9), (9, 256), (256, 9), (9, 48)])
    def test_bit_serial_count_counts_the_first_kernels_work(self, La, Lb):
        """The bit-serial count (kept beside the comb's bound) counts the
        (limb, output limb) pairs that a bit-serial loop visits, 32 steps of
        2 ops each."""
        Ls, Lg = min(La, Lb), max(La, Lb)
        pairs = sum(min(Ls - 1, m) - max(0, m - Lg) + 1 for m in range(Ls + Lg))
        assert profiling.clmul_ops(3, La, Lb) == 3 * pairs * 32 * 2
        smem, ops = profiling.clmul_comb_work(3, La, Lb)
        assert (smem, ops) == (3 * pairs * 15 * 4, 3 * pairs * 16)


class TestTrace:
    def test_trace_writes_profile(self, tmp_path):
        logdir = str(tmp_path / "trace")
        with profiling.trace(logdir) as d:
            torch.arange(128) * 2
        assert d == logdir
        with open(os.path.join(logdir, "trace.json")) as f:
            assert "traceEvents" in json.load(f)

    def test_device_time_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.device_busy(lambda: torch.zeros(4))

    def test_records_lost_in_one_trace_are_counted_from_the_others(self, monkeypatch):
        """Every call launches the same kernels: a name's count a call is
        the most any of the three traces holds, rounded up to whole calls,
        and its time that count times its mean record time.  Three empty
        traces raise."""
        import torch.profiler
        from torch.autograd import DeviceType

        def event(name, us):
            return types.SimpleNamespace(device_type=DeviceType.CUDA, name=name,
                                         time_range=types.SimpleNamespace(elapsed_us=lambda: us))

        # two calls a trace, each a k2 of 100 us and a t1 of 10 us; the first
        # trace lost a t1, the second everything, the third a k2 and a t1
        traces = [[event("k2", 100.0), event("k2", 100.0), event("t1", 10.0)], [],
                  [event("k2", 100.0), event("t1", 10.0)]]

        class FakeProfile:
            def __init__(self, activities):
                self.trace = traces.pop(0)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return self.trace

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
        assert profiling.device_records(lambda: None, 2) == pytest.approx({"k2": 0.2, "t1": 0.02})
        assert traces == []
        traces.extend([[]] * 3)
        with pytest.raises(RuntimeError, match="no device time in 3 traces"):
            profiling.device_busy(lambda: None)


class TestCompilationCache:
    def test_enable_is_idempotent_and_creates_dir(self, tmp_path, monkeypatch):
        monkeypatch.setattr(cache, "_enabled", None)
        d = str(tmp_path / "build_cache")
        got = ht.enable_compilation_cache(d)
        assert got == d and os.path.isdir(d)
        assert ht.enable_compilation_cache(d) == d  # second call is a no-op
        assert cache.build_dir() == tmp_path / "build_cache"

    def test_builds_land_in_the_cache(self, tmp_path, monkeypatch):
        from homomorph_tpu_torch import native
        from homomorph_tpu_torch.gf2 import cuda_build

        monkeypatch.setattr(cache, "_enabled", None)
        ht.enable_compilation_cache(str(tmp_path / "c"))
        assert cuda_build._target("clmul").parent == tmp_path / "c"
        monkeypatch.setattr(native, "_lib", None)
        assert native._build().parent == tmp_path / "c"

    def test_default_and_environment(self, tmp_path, monkeypatch):
        monkeypatch.setattr(cache, "_enabled", None)
        monkeypatch.delenv(cache.CACHE_ENV, raising=False)
        assert cache.build_dir().name == "_build"
        assert cache.build_dir().parent.name == "homomorph_tpu_torch"
        monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path / "env"))
        assert cache.build_dir() == tmp_path / "env"
        assert ht.enable_compilation_cache() == str(tmp_path / "env")
