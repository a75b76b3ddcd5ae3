"""The port's hashing tokenizer and featurizer against the JAX package's:
the same text and the same serialized messages must give identical rows."""
import numpy as np
import pytest

from detectmateservice_tpu.library.detectors import JaxScorerDetector
from detectmateservice_tpu.models import tokenizer as ref
from detectmateservice_tpu.schemas import ParserSchema
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.models import tokenizer as port
from detectmateservice_tpu_torch.schemas import ParserSchema as PortParser

_WORDS = ["user", "Login", "ERROR", "sshd[123]", "10.0.0.1", "GET /a/b?c=d",
          "ÄÖÜ", "ß", "日本", "🙂", "", "  ", "--", "x" * 40, "CamelCase", "0x1F"]


def _lines(seed, n=200):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_WORDS, size=int(rng.integers(0, 50))))
            for _ in range(n)]


@pytest.mark.parametrize("vocab,seq_len,lowercase", [
    (4096, 16, True), (32768, 32, True), (50000, 8, False), (4, 3, True)])
def test_rows_identical(vocab, seq_len, lowercase):
    a = ref.HashTokenizer(vocab, seq_len, lowercase)
    b = port.HashTokenizer(vocab, seq_len, lowercase)
    lines = _lines(vocab + seq_len)
    np.testing.assert_array_equal(b.encode_batch(lines), a.encode_batch(lines))
    for line in lines[:50]:
        np.testing.assert_array_equal(b.encode(line), a.encode(line))
        assert b.tokens(line) == a.tokens(line)
        row_a = np.zeros(seq_len, np.int32)
        row_b = np.zeros(seq_len, np.int32)
        a.encode_into(line, row_a)
        b.encode_into(line, row_b)
        np.testing.assert_array_equal(row_b, row_a)
    header = {"Time": "1700000000", "host": "h1", "Zeta": "z"}
    np.testing.assert_array_equal(
        b.encode_parsed("t <*> x", ["v1", "v 2"], header),
        a.encode_parsed("t <*> x", ["v1", "v 2"], header))


def test_reserved_ids_and_narrowing():
    assert (port.PAD_ID, port.MASK_ID, port.CLS_ID) == (ref.PAD_ID, ref.MASK_ID, ref.CLS_ID)
    rows = np.random.default_rng(0).integers(0, 65536, (8, 4)).astype(np.int32)
    for vocab in (65536, 65537):
        got, want = port.narrow_tokens(rows, vocab), ref.narrow_tokens(rows, vocab)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        port.HashTokenizer(vocab_size=3)


@pytest.mark.parametrize("native", [True, False])
def test_detector_featurize_matches_jax_detector(native):
    """The port featurizes serialized ParserSchema bytes natively (its own
    C featurizer) or in Python; its rows equal the JAX detector's either
    way."""
    rng = np.random.default_rng(3)
    msgs = []
    for i in range(120):
        lfv = {} if i % 3 else {"Time": str(1_700_000_000 + i), "b": "x y", "a": "ä"}
        msgs.append(ParserSchema(
            EventID=i % 5, template=" ".join(rng.choice(_WORDS, size=4)),
            variables=list(rng.choice(_WORDS, size=int(rng.integers(0, 5)))),
            logID=str(i), logFormatVariables=lfv).serialize())
    msgs.append(b"\x0a\xff")  # truncated: not featurizable on either side
    cfg = {"auto_config": False, "vocab_size": 4096, "seq_len": 16,
           "native_featurize": native}
    jax_det = JaxScorerDetector(config=dict(cfg, method_type="jax_scorer"))
    port_det = TorchScorerDetector(config=dict(cfg, method_type="torch_scorer",
                                               device="cpu"))
    tok_a, ok_a = jax_det._featurize_raw_batch(msgs)
    tok_b, ok_b = port_det._featurize_raw_batch(msgs)
    np.testing.assert_array_equal(ok_b, ok_a)
    assert not ok_b[-1]
    np.testing.assert_array_equal(tok_b[ok_b], tok_a[ok_a])
    one = ParserSchema.from_bytes(msgs[0])
    np.testing.assert_array_equal(
        port_det.featurize(PortParser.from_bytes(msgs[0])), jax_det.featurize(one))
