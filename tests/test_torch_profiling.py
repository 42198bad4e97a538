"""The port's profiling and cache utilities
(``homomorph_tpu_torch.utils.profiling``, ``homomorph_tpu_torch.utils.cache``)
on the CPU: the H100 peaks and speed-of-light models (the SM count and
clock given by hand), the device records, the program's spans and counters
(under ``torch.profiler`` on the CPU, and inside ``tracing()``), and
``enable_compilation_cache``."""

import types
import os
from collections import Counter

import pytest
import torch

import homomorph_tpu_torch as ht
from homomorph_tpu_torch.utils import cache, profiling

H100 = dict(sms=132, mhz=1980.0)


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


class TestDeviceRecords:
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


    def test_record_function_shadows_are_no_device_time(self, monkeypatch):
        """A ``record_function`` range (a span of the program) leaves a
        shadow on the device's timeline: it is no kernel and no copy."""
        import torch.profiler
        from torch.autograd import DeviceType

        def event(name, us, annotation=False):
            return types.SimpleNamespace(device_type=DeviceType.CUDA, name=name,
                                         is_user_annotation=annotation,
                                         time_range=types.SimpleNamespace(elapsed_us=lambda: us))

        class FakeProfile:
            def __init__(self, activities):
                pass

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return [event("compiled.call", 500.0, True), event("k1", 40.0),
                        event("graph.replay", 300.0, True)]

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
        assert profiling.device_records(lambda: None, 1) == pytest.approx({"k1": 0.04})


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_context(params=(256, 16, 1, 16)):
    ctx = ht.Context(ht.Parameters(*params), source=ht.ThreefrySource(1), device="cpu")
    ctx.generate_secret_key()
    ctx.generate_public_key()
    return ctx


class TestCounters:
    """The registry's arithmetic: eager counts add at once; what is counted
    while a graph is captured is set aside as its manifest, and each replay
    adds the manifest once."""

    @pytest.mark.parametrize("replays", [0, 1, 7])
    def test_totals_are_eager_counts_plus_manifests_times_replays(self, replays):
        c = profiling.Counters()
        c.add("K1", 3)
        c.add("C3", 2)
        with c.aside() as captured:
            c.add("K1", 5)
            c.add("C3")
            c.add("mask.K1", 4)
        assert captured == {"K1": 5, "C3": 1, "mask.K1": 4}
        assert (c["K1"], c["C3"], c["mask.K1"]) == (3, 2, 0)  # a capture launches nothing
        for _ in range(replays):
            c.replay(captured)
        c.add("K1")  # an eager launch after the capture
        assert c["K1"] == 4 + 5 * replays
        assert c["C3"] == 2 + replays
        assert c["mask.K1"] == 4 * replays
        snap = c.snapshot()
        assert set(profiling.KERNELS) <= set(snap) and snap["R1"] == 0
        assert snap["K1"] == c["K1"] and snap.get("mask.K1", 0) == 4 * replays

    def test_aside_restores_on_error_and_nests(self):
        c = profiling.Counters()
        with pytest.raises(RuntimeError):
            with c.aside() as outer:
                c.add("X1")
                with c.aside() as inner:
                    c.add("X1", 2)
                raise RuntimeError("a capture failed")
        assert inner == {"X1": 2} and outer == {"X1": 1} and c["X1"] == 0

    def test_cpu_and_meta_calls_launch_nothing(self):
        from homomorph_tpu_torch.gf2 import kernels as k

        a, b = torch.ones((3, 5), dtype=torch.int32), torch.ones((3, 7), dtype=torch.int32)
        before = profiling.counters.snapshot()
        k.clmul_rows(a, b)
        k.clmul_rows(a.to("meta"), b.to("meta"))
        after = profiling.counters.snapshot()
        moved = {key: after[key] - before.get(key, 0) for key in after if after[key] != before.get(key, 0)}
        assert moved == {}


class TestSpans:
    def test_span_tree_of_an_eager_product_under_the_profiler(self, monkeypatch):
        """One checked u8 product on the CPU, the route forced at every
        width: the context's span holds the carry-save levels, the ripple
        steps and the route's plan, split, leaves and join, every span one
        request.  Only the spans of ``PROFILER_RANGES`` are ``record_function``
        ranges in the profiler's events: a compiled call's, not these."""
        from torch.profiler import ProfilerActivity, profile

        from homomorph_tpu_torch.gf2 import kernels as k
        from homomorph_tpu_torch.models import HomomorphicAddition, HomomorphicMultiplication
        from homomorph_tpu_torch.models.compiled import compile_op2

        ctx = tiny_context()
        a, b = ctx.encrypt([3, 5], ht.U8, batch=True), ctx.encrypt([7, 11], ht.U8, batch=True)
        add = compile_op2(HomomorphicAddition, ht.U8, ctx.parameters.pk_degree)
        add(a, b)  # its metadata from meta tensors, before the route is forced
        monkeypatch.setenv(k.FORCE_KARATSUBA_ENV, "1")
        monkeypatch.setenv(k.KARATSUBA_MIN_ENV, "4")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = ctx.apply2(HomomorphicMultiplication, a, b)
            add(a, b)
        assert [int(v) for v in ctx.decrypt(out)] == [21, 55]
        everything = profiling.records()
        recs = [r for r in everything if r.request == everything[0].request]
        assert {r.name for r in everything if r not in recs} >= {"compiled.call"}
        names = Counter(r.name for r in recs)
        assert names["context.apply"] == 1 and recs[0].name == "context.apply"
        for name in ("circuit.csa_level", "circuit.ripple", "route.plan", "route.split",
                     "route.leaves", "route.join"):
            assert names[name] > 0, name
        assert set(names) <= {"context.apply", "circuit.csa_level", "circuit.ripple",
                              "route.plan", "route.split", "route.leaves", "route.join"}
        assert {r.request for r in recs} == {recs[0].request}
        by_id = {r.id: r for r in recs}
        for r in recs[1:]:  # each inside its parent; the circuit's spans inside the call's
            parent = by_id[r.parent]
            assert parent.start <= r.start <= r.end <= parent.end
            assert parent.name in ("context.apply", "circuit.csa_level", "circuit.ripple")
            assert r.name.startswith("route.") or parent.name == "context.apply"
        named = {r.name for r in everything}
        assert Counter(e.name for e in prof.events() if e.name in named) == {"compiled.call": 1}

    def test_off_means_off(self, monkeypatch):
        """With no profiler and no ``tracing()``, a checked call and a
        compiled call make no record and never enter ``record_function``."""
        from homomorph_tpu_torch.models import HomomorphicAddition
        from homomorph_tpu_torch.models.compiled import compile_op2

        def refuse(*args, **kwargs):
            raise AssertionError("record_function entered while tracing is off")

        with profiling.tracing():
            pass  # an empty session: the last one's records are gone
        monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        ctx = tiny_context()
        a, b = ctx.encrypt([3, 5], ht.U8, batch=True), ctx.encrypt([7, 11], ht.U8, batch=True)
        assert not profiling.tracing_on()
        out = ctx.apply2(HomomorphicAddition, a, b)
        fn = compile_op2(HomomorphicAddition, ht.U8, ctx.parameters.pk_degree)
        assert torch.equal(fn(a, b).limbs, out.limbs)
        assert [int(v) for v in ctx.decrypt(out)] == [10, 16]
        assert profiling.records() == []
        assert profiling.span("x") is profiling.span("y")  # one shared object

    def test_tracing_records_without_the_profiler_and_a_new_session_hides_the_last(
            self, monkeypatch):
        """Inside ``tracing()`` the compiled round trip's spans are kept in
        memory (no ``record_function``): one request a call, the call's
        span around the bits' copy, the first shape's mask and the keys;
        reading leaves them, and the next session drops them."""
        import numpy as np

        from homomorph_tpu_torch import rng as hrng
        from homomorph_tpu_torch.models import HomomorphicAddition
        from homomorph_tpu_torch.models.compiled import compile_roundtrip

        def refuse(*args, **kwargs):
            raise AssertionError("record_function entered without a profiler")

        monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
        ctx = tiny_context((64, 16, 1, 16))
        fn = compile_roundtrip(ctx, HomomorphicAddition, ht.U8)
        bits = [np.unpackbits(np.array([[v]], dtype=np.uint8), axis=1, bitorder="little")
                for v in (9, 30)]
        with profiling.tracing():
            assert profiling.tracing_on()
            for seed in (1, 2):
                out = fn(hrng.threefry_key(seed), *bits)
                assert np.packbits(out.numpy().astype(np.uint8), bitorder="little")[0] == 39
        assert not profiling.tracing_on()
        recs = profiling.records()
        first = recs[0].request
        assert [(r.name, r.request - first) for r in recs
                if r.name.startswith(("compiled.", "roundtrip."))] == [
            ("compiled.call", 0), ("roundtrip.bits_in", 0), ("roundtrip.mask", 0),
            ("roundtrip.keys", 0), ("compiled.call", 1), ("roundtrip.bits_in", 1),
            ("roundtrip.keys", 1)]
        calls = [r for r in recs if r.name == "compiled.call"]
        assert all(r.parent is None and r.seconds > 0 for r in calls)
        assert all(r.parent in {c.id for c in calls} for r in recs if r.name.startswith("roundtrip"))
        assert {r.request for r in recs} == {first, first + 1}  # the circuit's spans too
        assert all(r.counts == {} for r in recs if r.name.startswith("roundtrip."))
        assert profiling.records() == recs  # reading does not drain
        with profiling.tracing():
            pass
        assert profiling.records() == []

    def test_spans_close_on_error_and_the_ring_keeps_the_newest(self, monkeypatch):
        from collections import deque

        with profiling.tracing():
            monkeypatch.setattr(profiling._tracer, "records", deque(maxlen=4))
            with pytest.raises(ValueError):
                with profiling.span("outer"):
                    with profiling.span("inner") as s:
                        s.add("bytes", 8)
                        profiling.annotate("bytes", 2)
                        raise ValueError("boom")
            for i in range(5):
                with profiling.span(f"s{i}"):
                    profiling.annotate("launches", i)
        recs = profiling.records()
        assert [r.name for r in recs] == ["s1", "s2", "s3", "s4"]
        assert [r.counts for r in recs] == [{"launches": i} for i in range(1, 5)]
        assert len({r.request for r in recs}) == 4 and profiling._tracer.stack == []

    def test_device_spans_read_their_events_when_read(self):
        """A device span's ``device_ms`` is read from its two events once
        the records are read (or settled), in the open span's request."""
        waited = []

        class Event:
            def __init__(self, t):
                self.t = t

            def synchronize(self):
                waited.append(self.t)

            def elapsed_time(self, end):
                return end.t - self.t

        with profiling.tracing():
            with profiling.span("compiled.call"):
                profiling.device_span("roundtrip.decrypt", Event(1.0), Event(3.5))
            assert waited == []
        profiling.device_span("ignored", Event(0.0), Event(1.0))  # tracing is off
        recs = profiling.records()
        assert [(r.name, r.parent, r.counts) for r in recs] == [
            ("compiled.call", None, {}), ("roundtrip.decrypt", recs[0].id, {"device_ms": 2.5})]
        assert recs[1].request == recs[0].request and recs[1].seconds is None
        assert waited == [3.5]



class TestDeviceRegions:
    """``device_region``: a host span off the card; on the card (its
    events faked here) two timing events kept by the capture that records
    them, or eagerly a device span; and ``clmul.expand``, the limbs the
    clmul dispatcher writes to copy a broadcast operand."""

    def test_off_the_card_a_region_is_a_host_span(self):
        cpu = torch.device("cpu")
        with profiling.tracing():
            with profiling.span("compiled.call"):
                with profiling.device_region("circuit.select", cpu):
                    pass
        recs = profiling.records()
        assert [(r.name, r.parent, r.counts) for r in recs] == [
            ("compiled.call", None, {}), ("circuit.select", recs[0].id, {})]
        assert recs[1].seconds >= 0 and recs[1].request == recs[0].request
        assert profiling.device_region("x", cpu) is profiling.span("y")  # tracing off: nothing

    def test_a_capture_keeps_its_regions_and_an_eager_region_is_a_device_span(self, monkeypatch):
        clock = iter(range(1, 100))

        class Event:
            def __init__(self, enable_timing=False, external=False):
                self.timing, self.external, self.t = enable_timing, external, None

            def record(self):
                self.t = next(clock)

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                return float(end.t - self.t)

        capturing = [True]
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
        cuda = torch.device("cuda")
        off = profiling.span("off")
        assert profiling.device_region("circuit.lt_tree", cuda) is off  # no capture keeps it
        with profiling.regions() as found:
            with profiling.device_region("circuit.lt_tree", cuda):
                with profiling.device_region("circuit.select", cuda):
                    pass
        assert [(n, s.t, e.t) for n, (s, e) in found] == [  # kept as each closes
            ("circuit.select", 2, 3), ("circuit.lt_tree", 1, 4)]
        assert all(ev.timing and ev.external for _, evs in found for ev in evs)
        assert profiling._tracer.captures == []
        capturing[0] = False
        assert profiling.device_region("circuit.select", cuda) is off  # tracing off
        with profiling.tracing():
            with profiling.span("compiled.call"):
                with profiling.device_region("circuit.select", cuda):
                    pass
        recs = profiling.records()
        assert [(r.name, r.parent, r.counts) for r in recs] == [
            ("compiled.call", None, {}), ("circuit.select", recs[0].id, {"device_ms": 1.0})]

    @pytest.mark.parametrize("a_shape,b_shape,expanded", [
        ((5, 1, 384), (5, 32, 9), 5 * 32 * 384),  # the mux's condition against its lanes
        ((5, 32, 9), (5, 1, 384), 5 * 32 * 384),
        ((1, 9), (4, 3, 9), 4 * 3 * 9),
        ((2, 1, 7), (1, 3, 5), 2 * 3 * 7 + 2 * 3 * 5),
        ((5, 32, 9), (5, 32, 9), 0),
        ((6, 24), (6, 24), 0),
    ])
    def test_clmul_counts_the_limbs_it_writes_to_expand_a_broadcast_operand(
            self, a_shape, b_shape, expanded):
        from homomorph_tpu_torch.gf2 import kernels as k

        gen = torch.Generator().manual_seed(5)

        def limbs(shape):
            return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int32)

        a, b = limbs(a_shape), limbs(b_shape)
        before = profiling.counters["clmul.expand"]
        got = k.clmul(a, b)
        assert profiling.counters["clmul.expand"] - before == expanded
        lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        want = k.clmul(a.expand(*lead, a.shape[-1]).clone(), b.expand(*lead, b.shape[-1]).clone())
        assert torch.equal(got, want)
        before = profiling.counters["clmul.expand"]
        k.clmul(a.to("meta"), b.to("meta"))  # writes nothing
        assert profiling.counters["clmul.expand"] == before

    def test_a_compiled_max_on_the_cpu_holds_the_tree_and_the_mux(self):
        """Off the card the compiled u8 max runs eagerly: inside
        ``tracing()`` its call's request holds one host span of the tree and
        one of the mux, the mux's inside its call; the maxima decrypt."""
        from homomorph_tpu_torch.models import HomomorphicAddition, HomomorphicMaximum
        from homomorph_tpu_torch.models.compiled import compile_op2

        ctx = tiny_context()
        xs, ys = [3, 200, 7, 255], [40, 13, 7, 0]
        a, b = ctx.encrypt(xs, ht.U8, batch=True), ctx.encrypt(ys, ht.U8, batch=True)
        fn = compile_op2(HomomorphicMaximum, ht.U8, ctx.parameters.pk_degree)
        add = compile_op2(HomomorphicAddition, ht.U8, ctx.parameters.pk_degree)
        fn(a, b), add(a, b)  # the first calls derive their metadata on the meta device
        with profiling.tracing():
            out = fn(a, b)
            add(a, b)
        assert [int(v) for v in ctx.decrypt(out)] == [max(x, y) for x, y in zip(xs, ys)]
        recs = profiling.records()
        calls = [r for r in recs if r.name == "compiled.call"]
        assert len(calls) == 2
        regions = [(r.name, r.request) for r in recs
                   if r.name in ("circuit.lt_tree", "circuit.select")]
        assert regions == [("circuit.lt_tree", calls[0].request),
                           ("circuit.select", calls[0].request)]

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
