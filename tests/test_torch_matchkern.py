"""The port's native featurizer (``utils/matchkern.py`` over
``native/dmfeat.c``) against the JAX package's (``utils/matchkern.py`` over
``native/matchkern/dmkern.c``) and against the port's Python rows: the same
messages must give bit-equal rows and equal ok flags, and the detector must
featurize every row in C or refuse to boot. The cases of
``tests/test_native_kernels.py`` (``TestFeaturizeParity``,
``TestMapOverflowParity``, ``TestFeaturizeFuzzParity``,
``TestNativeFeaturizeKnob``) are carried over as cases here."""
import random
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from detectmateservice_tpu.library.detectors import JaxScorerDetector
from detectmateservice_tpu.models.tokenizer import HashTokenizer as RefTokenizer
from detectmateservice_tpu.schemas import ParserSchema
from detectmateservice_tpu.utils import matchkern as ref
from detectmateservice_tpu_torch.library.common.core import LibraryError
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.models.tokenizer import HashTokenizer
from detectmateservice_tpu_torch.utils import matchkern

REPO = Path(__file__).resolve().parents[1]


def bench_stream(n, seed=0, anomaly_rate=0.01):
    """bench.py's ``make_messages`` shape from ``np.random.default_rng``."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(n):
        if rng.random() < anomaly_rate:
            template, variables = "segfault at <*> ip <*> sp <*>", [
                hex(rng.integers(2**30)) for _ in range(3)]
        else:
            template, variables = "type=<*> msg=audit(<*>): pid=<*> uid=<*> comm=<*>", [
                "SYSCALL", f"17000{i % 100}.{i % 997}", str(int(rng.integers(300, 500))),
                str(int(rng.integers(0, 4))), ["cron", "sshd", "systemd", "bash"][i % 4]]
        msgs.append(ParserSchema(
            EventID=1, template=template, variables=variables, logID=str(i),
            logFormatVariables={"Time": str(1_700_000_000 + i)}).serialize())
    return msgs


def port_detector(**over):
    cfg = {"method_type": "torch_scorer", "auto_config": False, "device": "cpu",
           "seq_len": 32, "vocab_size": 4096, "data_use_training": 0, **over}
    return TorchScorerDetector(config=cfg)


def jax_detector(**over):
    cfg = {"method_type": "jax_scorer", "auto_config": False, "seq_len": 32,
           "vocab_size": 4096, "data_use_training": 0, **over}
    return JaxScorerDetector(config=cfg)


def python_rows(msgs, seq_len, vocab):
    """The port's Python rows (its own proto3 codec and tokenizer)."""
    det = port_detector(seq_len=seq_len, vocab_size=vocab, native_featurize=False)
    return det._featurize_raw_batch(msgs)


class TestFeatureVersion:
    def test_port_version_is_the_c_source_default(self):
        src = matchkern.SOURCE.read_text()
        found = re.search(r"#define DM_FEATURE_VERSION (\d+)", src)
        assert found and int(found.group(1)) == matchkern.DM_FEATURE_VERSION
        assert matchkern.lib_feature_version() == matchkern.DM_FEATURE_VERSION
        assert matchkern.DM_FEATURE_VERSION == ref.DM_FEATURE_VERSION

    def test_library_is_the_ports_own_build(self):
        lib = matchkern.load()
        path = Path(lib._name).resolve()
        assert path.parent == matchkern.BUILD_DIR.resolve()
        assert path == matchkern.library_path().resolve()


@pytest.mark.parametrize("seq_len,vocab,seed", [(32, 32768, 0), (16, 4096, 1), (8, 50000, 2)])
def test_bench_stream_rows_equal_both_references(seq_len, vocab, seed):
    msgs = bench_stream(600, seed=seed, anomaly_rate=0.05)
    got, ok = matchkern.featurize_batch(msgs, seq_len, vocab)
    want, want_ok = ref.featurize_batch(msgs, seq_len, vocab)
    assert ok.all() and want_ok.all()
    np.testing.assert_array_equal(got, want)
    py, py_ok = python_rows(msgs, seq_len, vocab)
    assert py_ok.all()
    np.testing.assert_array_equal(got, py)


class TestFeaturizeParity:
    def test_matches_python_path(self):
        tok = HashTokenizer(vocab_size=32768, seq_len=32)
        msgs, py_rows = [], []
        for i in range(64):
            template = f"event <*> type {i % 5} from <*>"
            variables = [f"val{i}", f"host-{i % 9}"]
            hv = {"Time": str(1700000000 + i), "level": "WARN", "b": "x", "a": f"y{i}"}
            msgs.append(ParserSchema(EventID=i, template=template, variables=variables,
                                     logFormatVariables=hv).serialize())
            parts = [template] + variables + [f"{k}={v}" for k, v in sorted(hv.items())]
            py_rows.append(tok.encode(" ".join(parts)))
        rows, ok = matchkern.featurize_batch(msgs, 32, 32768)
        assert ok.all()
        np.testing.assert_array_equal(rows, np.stack(py_rows))
        np.testing.assert_array_equal(rows, ref.featurize_batch(msgs, 32, 32768)[0])

    @pytest.mark.parametrize("raw", [b"\xff\xff\xff\xff", b"\x0a\xff", b"\x2a\x05abc",
                                     b"\x08", b"\x0b\x00"])
    def test_garbage_flagged_not_ok(self, raw):
        _, ok = matchkern.featurize_batch([raw], 16, 1024)
        _, ref_ok = ref.featurize_batch([raw], 16, 1024)
        assert not ok[0] and not ref_ok[0]
        _, py_ok = python_rows([raw], 16, 1024)
        assert not py_ok[0]

    def test_empty_message_ok(self):
        rows, ok = matchkern.featurize_batch([ParserSchema().serialize()], 16, 1024)
        assert ok[0]
        assert rows[0][0] == 2 and not rows[0][1:].any()  # CLS only

    def test_empty_batch(self):
        rows, ok = matchkern.featurize_batch([], 16, 1024)
        assert rows.shape == (0, 16) and ok.shape == (0,)


@pytest.mark.parametrize("text", [
    "simple line", "", "MIXED Case 123", "punct!@#$%^&*()sep",
    "unicode café line", "a" * 500, "naïve ÜBER straße 日本",
])
def test_encode_batch_matches_both_references(text):
    got = matchkern.encode_batch([text], 16, 4096)
    np.testing.assert_array_equal(got, ref.encode_batch([text], 16, 4096))
    np.testing.assert_array_equal(got, HashTokenizer(4096, 16).encode_batch([text]))


class TestMapOverflowParity:
    @pytest.mark.parametrize("entries", [60, 64])
    def test_native_rows_match_python_at_and_below_limit(self, entries):
        lfv = {f"key{i:03d}": f"value{i}" for i in range(entries)}
        raw = ParserSchema(EventID=1, template="t <*>", variables=["x"],
                           logFormatVariables=lfv).serialize()
        native, ok = matchkern.featurize_batch([raw], 512, 32768)
        assert ok.all()
        py, py_ok = python_rows([raw], 512, 32768)
        assert py_ok.all()
        np.testing.assert_array_equal(native, py)
        np.testing.assert_array_equal(native, ref.featurize_batch([raw], 512, 32768)[0])

    @pytest.mark.parametrize("entries", [65, 100])
    def test_many_header_variables_retried_in_python(self, entries):
        """Above 64 entries the C side refuses the row and the detector
        retries it in Python: the row equals the all-Python row and the JAX
        detector's, and counts as a fallback row."""
        lfv = {f"key{i:03d}": f"value{i}" for i in range(entries)}
        raw = ParserSchema(EventID=1, template="t <*>", variables=["x"],
                           logFormatVariables=lfv).serialize()
        assert not matchkern.featurize_batch([raw], 512, 32768)[1][0]
        det = port_detector(seq_len=512, vocab_size=32768)
        tokens, ok = det._featurize_raw_batch([raw])
        assert ok.all()
        assert det.featurize_rows == {"native": 0, "fallback": 1}
        py, _ = python_rows([raw], 512, 32768)
        np.testing.assert_array_equal(tokens, py)
        want, _ = jax_detector(seq_len=512, vocab_size=32768)._featurize_raw_batch([raw])
        np.testing.assert_array_equal(tokens, want)


class TestFeaturizeFuzzParity:
    """Over randomized messages (unicode, truncation at seq_len, ragged and
    empty variables, header-map ordering, the two ASCII-lowering codepoints
    the C side must refuse) the detector's rows equal
    ``HashTokenizer.encode_parsed``, the JAX detector's, and the port's
    Python rows."""

    SEQ_LEN = 24
    VOCAB = 4096
    _POOLS = (
        "abcdefXYZ0189",
        "=_-./:!?#@%&*()[]{}",
        " \t\r\n\x1c\x1d",
        "céäßøñ",
        "日本語ログイン検出",
        "Ωπ𝔘🚀",
        "\u0130\u212a",    # U+0130 / U+212A: ASCII-lowering
        "A" * 40,
    )

    def _rand_text(self, rng, max_len=48):
        pool = (self._POOLS[-2] if rng.random() < 0.02
                else rng.choice(self._POOLS[:-2] + self._POOLS[-1:]))
        return "".join(rng.choice(pool) for _ in range(rng.randrange(max_len)))

    def _messages(self, rng, n):
        msgs, expected = [], []
        tok = RefTokenizer(vocab_size=self.VOCAB, seq_len=self.SEQ_LEN)
        for i in range(n):
            template = self._rand_text(rng)
            variables = [self._rand_text(rng) for _ in range(rng.randrange(8))]
            if rng.random() < 0.3:
                variables.append("")
            hv = {}
            for _ in range(rng.randrange(6)):
                hv[self._rand_text(rng, 12)] = self._rand_text(rng, 20)
            if rng.random() < 0.1:
                hv[""] = self._rand_text(rng, 8)
            msgs.append(ParserSchema(EventID=i, template=template, variables=variables,
                                     logID=str(i), logFormatVariables=hv).serialize())
            expected.append(tok.encode_parsed(template, variables, hv))
        return msgs, np.stack(expected)

    @pytest.mark.parametrize("seed", [0xD317, 0x5EED])
    def test_fuzz_detector_path_matches_every_reference(self, seed):
        msgs, expected = self._messages(random.Random(seed), 1200)
        det = port_detector(seq_len=self.SEQ_LEN, vocab_size=self.VOCAB)
        tokens, ok = det._featurize_raw_batch(msgs)
        assert ok.all(), "valid serialized messages must all featurize"
        np.testing.assert_array_equal(tokens, expected)
        want, want_ok = jax_detector(seq_len=self.SEQ_LEN,
                                     vocab_size=self.VOCAB)._featurize_raw_batch(msgs)
        assert want_ok.all()
        np.testing.assert_array_equal(tokens, want)
        py, _ = python_rows(msgs, self.SEQ_LEN, self.VOCAB)
        np.testing.assert_array_equal(tokens, py)
        rows = det.featurize_rows
        assert rows["native"] + rows["fallback"] == len(msgs)
        assert rows["fallback"] > 0, "the fuzz pools should give refused rows"
        assert rows["native"] > rows["fallback"], "most rows must ride the native path"

    def test_fuzz_raw_kernel_flags_never_lie(self):
        """Every row the C side reports ok is already exact, and its flags
        are the JAX package's."""
        msgs, expected = self._messages(random.Random(0xBEEF), 400)
        tokens, ok = matchkern.featurize_batch(msgs, self.SEQ_LEN, self.VOCAB)
        idx = np.flatnonzero(ok)
        assert 0 < len(idx) < len(msgs)
        np.testing.assert_array_equal(tokens[idx], expected[idx])
        ref_tokens, ref_ok = ref.featurize_batch(msgs, self.SEQ_LEN, self.VOCAB)
        np.testing.assert_array_equal(ok, ref_ok)
        np.testing.assert_array_equal(tokens, ref_tokens)

    @pytest.mark.parametrize("text", ["\u0130stanbul", "3\u212a resistor",
                                      "deep \u0130 \u212a mix"])
    def test_ascii_lowering_codepoints_flagged(self, text):
        raw = ParserSchema(template=text, variables=[], logFormatVariables={}).serialize()
        _, ok = matchkern.featurize_batch([raw], 16, 1024)
        assert not ok[0]
        tokens, ok = port_detector(seq_len=16, vocab_size=1024)._featurize_raw_batch([raw])
        assert ok[0]
        np.testing.assert_array_equal(tokens[0], HashTokenizer(1024, 16).encode_parsed(
            text, [], {}))

    def test_invalid_utf8_template_flagged(self):
        raw = b"\x2a\x03\xff\xfe\x41"  # field 5, length 3, invalid UTF-8
        _, ok = matchkern.featurize_batch([raw], 16, 1024)
        assert not ok[0]
        _, ok = port_detector(seq_len=16, vocab_size=1024)._featurize_raw_batch([raw])
        _, want_ok = jax_detector(seq_len=16, vocab_size=1024)._featurize_raw_batch([raw])
        assert not ok[0] and not want_ok[0]

    def test_duplicate_wire_map_keys_last_wins(self):
        entry1 = b"\x0a\x01k\x12\x01a"     # k -> a
        entry2 = b"\x0a\x01k\x12\x01b"     # k -> b
        raw = (b"\x52" + bytes([len(entry1)]) + entry1
               + b"\x52" + bytes([len(entry2)]) + entry2)
        rows, ok = matchkern.featurize_batch([raw], 16, 1024)
        assert ok[0]
        want = HashTokenizer(vocab_size=1024, seq_len=16).encode_parsed("", [], {"k": "b"})
        np.testing.assert_array_equal(rows[0], want)
        py, py_ok = python_rows([raw], 16, 1024)
        assert py_ok[0]
        np.testing.assert_array_equal(py[0], want)

    def test_truncated_messages_agree_with_the_jax_detector(self):
        """Every prefix of a few messages: the ok flags and the rows of the
        rows both detectors accept are equal."""
        msgs, _ = self._messages(random.Random(7), 6)
        cut = [m[:k] for m in msgs for k in range(len(m) + 1)]
        tokens, ok = port_detector(seq_len=self.SEQ_LEN,
                                   vocab_size=self.VOCAB)._featurize_raw_batch(cut)
        want, want_ok = jax_detector(seq_len=self.SEQ_LEN,
                                     vocab_size=self.VOCAB)._featurize_raw_batch(cut)
        np.testing.assert_array_equal(ok, want_ok)
        np.testing.assert_array_equal(tokens[ok], want[want_ok])


class TestNativeFeaturizeKnob:
    def test_off_runs_every_row_in_python(self):
        msgs = [ParserSchema(EventID=i, template="t <*>", variables=[str(i)],
                             logFormatVariables={"k": "v"}).serialize() for i in range(16)]
        off = port_detector(native_featurize=False)
        tokens, ok = off._featurize_raw_batch(msgs)
        assert ok.all()
        assert off.featurize_rows == {"native": 0, "fallback": len(msgs)}
        assert not off._native_ready
        on = port_detector()
        tokens_on, ok_on = on._featurize_raw_batch(msgs)
        assert ok_on.all()
        np.testing.assert_array_equal(tokens, tokens_on)
        assert on.featurize_rows == {"native": len(msgs), "fallback": 0}

    @pytest.mark.parametrize("width", [1, 2, 3])
    def test_explicit_thread_width_applies(self, width):
        before = matchkern.featurize_threads()
        try:
            det = port_detector(featurize_threads=width)
            det.setup_io()
            assert matchkern.featurize_threads() == width
            msgs = bench_stream(700, seed=width)
            tokens, ok = det._featurize_raw_batch(msgs)
            assert ok.all()
            np.testing.assert_array_equal(tokens, ref.featurize_batch(msgs, 32, 4096)[0])
        finally:
            matchkern.set_featurize_threads(before)

    def test_auto_width_resolves(self):
        before = matchkern.featurize_threads()
        try:
            assert 1 <= matchkern.set_featurize_threads(0) <= 4
        finally:
            matchkern.set_featurize_threads(before)


def test_build_failure_raises_from_setup_io(tmp_path, monkeypatch):
    """A compiler that does not exist: setup_io raises LibraryError, and
    featurizing raises too; nothing runs the Python rows in its place."""
    monkeypatch.setattr(matchkern, "CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(matchkern, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(matchkern, "_lib", None)
    det = port_detector()
    with pytest.raises(LibraryError, match="native featurizer did not build"):
        det.setup_io()
    with pytest.raises(LibraryError):
        det._featurize_raw_batch(bench_stream(4))
    assert det.featurize_rows == {"native": 0, "fallback": 0}
    # with native_featurize off the detector boots without the library
    port_detector(native_featurize=False).setup_io()


def test_refused_source_raises(tmp_path, monkeypatch):
    bad = tmp_path / "dmfeat.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(matchkern, "SOURCE", bad)
    monkeypatch.setattr(matchkern, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(matchkern, "_lib", None)
    with pytest.raises(matchkern.NativeBuildError, match="failed on dmfeat.c"):
        matchkern.load()
    assert not list((tmp_path / "build").glob("*.so"))


def test_loads_nothing_from_the_jax_package():
    """In a fresh interpreter: the port featurizes and maps its own library,
    never one of ``detectmateservice_tpu/_native/``."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from detectmateservice_tpu_torch.utils import matchkern\n"
        "from detectmateservice_tpu_torch.engine.framing import pack_batch\n"
        "fb = matchkern.featurize_frames([pack_batch([b'\\x2a\\x01a'] * 3)], 8, 1024)\n"
        "assert fb.ok.all() and len(fb) == 3\n"
        "print(open('/proc/self/maps').read())\n")
    proc = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    maps = proc.stdout
    assert "detectmateservice_tpu/_native" not in maps
    assert "libdmkern" not in maps
    assert str(matchkern.library_path()) in maps


def test_concurrent_callers_get_their_own_rows():
    """Several threads featurize at once (the pool serves one job and the
    others run inline): every result equals the one-thread result."""
    batches = [bench_stream(300 + 50 * k, seed=k) for k in range(8)]
    want = [ref.featurize_batch(b, 32, 4096)[0] for b in batches]
    before = matchkern.featurize_threads()
    errors = []
    switch = sys.getswitchinterval()

    def work(k):
        for _ in range(5):
            got, ok = matchkern.featurize_batch(batches[k], 32, 4096)
            if not ok.all() or not np.array_equal(got, want[k]):
                errors.append(k)

    try:
        sys.setswitchinterval(1e-5)
        matchkern.set_featurize_threads(3)
        threads = [threading.Thread(target=work, args=(k,)) for k in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        matchkern.set_featurize_threads(before)
    assert errors == []
