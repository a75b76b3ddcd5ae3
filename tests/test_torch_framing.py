"""The port's batch frames (``engine/framing.py``) and its native frame
featurizer (``utils/matchkern.featurize_frames``) against the JAX package's
``engine/framing.py`` and ``utils/matchkern.py``, and against the port's
Python rows: the same frames must give the same bytes, messages, rows, ok
flags, spans, line counts and corrupt-frame counts."""
import numpy as np
import pytest

from detectmateservice_tpu.engine import framing as ref_framing
from detectmateservice_tpu.schemas import ParserSchema
from detectmateservice_tpu.utils import matchkern as ref
from detectmateservice_tpu_torch.engine import framing
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.utils import matchkern

from test_torch_matchkern import bench_stream

SEQ_LEN, VOCAB = 32, 4096


def _message(i, log=""):
    return ParserSchema(EventID=i, template=f"t{i} <*>", variables=[f"v{i}"], logID=str(i),
                        log=log, logFormatVariables={"Time": str(i)}).serialize()


def _corrupt_frames():
    good = framing.pack_batch([_message(1), _message(2)])
    return {
        "truncated_body": good[:-3],
        "trailing_bytes": good + b"\x00",
        "truncated_count": framing.MAGIC + b"\x80",
        "count_past_end": framing.MAGIC + b"\x05\x01a",
        "length_past_end": framing.MAGIC + b"\x01\x7fab",
    }


# name -> frames: packed frames of bench.py's shape, lone messages, empty
# frames, packed empty messages, messages with newlines, long messages (a
# two-byte length varint) and corrupt batch frames, alone and mixed
def _cases():
    stream = bench_stream(1500, seed=3)
    multiline = [_message(i, log="a\nb\n" * (i % 3) + "c" * (i % 2)) for i in range(40)]
    long = [_message(i, log="x" * (200 + i)) for i in range(8)]
    corrupt = list(_corrupt_frames().values())
    return {
        "bench_frames_of_512": [framing.pack_batch(stream[i:i + 512])
                                for i in range(0, len(stream), 512)],
        "single_messages": stream[:20],
        "empty_frames_and_packed_empties": [b"", framing.pack_batch([]),
                                            framing.pack_batch([b"", stream[0], b""]), b""],
        "newlines": [framing.pack_batch(multiline[:25])] + multiline[25:],
        "long_messages": [framing.pack_batch(long)],
        "corrupt": corrupt,
        "mixed": ([framing.pack_batch(stream[:100]), stream[100], corrupt[0], b"",
                   framing.pack_batch(multiline), corrupt[3], framing.pack_batch([b"\xff\xff"]),
                   stream[101]]),
    }


CASES = _cases()


def test_magic_and_error_type():
    assert framing.MAGIC == ref_framing.MAGIC == b"\xd7DM\x01"
    assert issubclass(framing.FramingError, ValueError)


@pytest.mark.parametrize("messages", [
    [], [b""], [b"a"], [b"x" * 127, b"y" * 128, b"z" * 20000], bench_stream(700, seed=5)])
def test_pack_batch_bytes_equal(messages):
    packed = framing.pack_batch(messages)
    assert packed == ref_framing.pack_batch(messages)
    assert framing.unpack_batch(packed) == ref_framing.unpack_batch(packed) == messages
    assert framing.frame_msg_count(packed) == ref_framing.frame_msg_count(packed) \
        == len(messages)


@pytest.mark.parametrize("data", [b"", b"plain message", _message(3),
                                  framing.MAGIC + b"\x80", framing.MAGIC + b"\x03"])
def test_single_and_garbled_frames_count_as_the_reference(data):
    assert framing.frame_msg_count(data) == ref_framing.frame_msg_count(data)
    if not data.startswith(framing.MAGIC):
        assert framing.unpack_batch(data) is None is ref_framing.unpack_batch(data)


@pytest.mark.parametrize("name", sorted(_corrupt_frames()))
def test_corrupt_frames_raise_as_the_reference(name):
    frame = _corrupt_frames()[name]
    with pytest.raises(ref_framing.FramingError):
        ref_framing.unpack_batch(frame)
    with pytest.raises(framing.FramingError):
        framing.unpack_batch(frame)
    assert TorchScorerDetector._expand_frame_python(frame) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_featurize_frames_equals_the_jax_package(name):
    frames = CASES[name]
    got = matchkern.featurize_frames(frames, SEQ_LEN, VOCAB)
    want = ref.featurize_frames(frames, SEQ_LEN, VOCAB)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.ok, want.ok)
    np.testing.assert_array_equal(got.spans, want.spans)
    assert got.n_lines == want.n_lines
    assert got.n_corrupt_frames == want.n_corrupt_frames
    assert [got.raw(i) for i in range(len(got))] == [want.raw(i) for i in range(len(want))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_featurize_frames_equals_python_expansion_and_rows(name):
    """The native frame pass against the port's Python path: expand each
    frame with ``unpack_batch`` (packed empties dropped), featurize the
    messages in Python, count lines by the engine's newline rule."""
    frames = CASES[name]
    got = matchkern.featurize_frames(frames, SEQ_LEN, VOCAB)
    msgs, corrupt = [], 0
    for frame in frames:
        expanded = TorchScorerDetector._expand_frame_python(frame)
        if expanded is None:
            corrupt += 1
        else:
            msgs.extend(expanded)
    assert got.n_corrupt_frames == corrupt
    assert [got.raw(i) for i in range(len(got))] == msgs
    assert got.n_lines == sum(max(1, m.count(b"\n") + (0 if m.endswith(b"\n") else 1))
                              for m in msgs)
    det = TorchScorerDetector(config={"method_type": "torch_scorer", "device": "cpu",
                                      "seq_len": SEQ_LEN, "vocab_size": VOCAB,
                                      "native_featurize": False})
    rows, ok = det._featurize_raw_batch(msgs)
    np.testing.assert_array_equal(got.ok, ok)
    np.testing.assert_array_equal(got.tokens[got.ok], rows[ok])


def test_span_raws_slice_lazily():
    frames = CASES["bench_frames_of_512"]
    fb = matchkern.featurize_frames(frames, SEQ_LEN, VOCAB)
    raws = matchkern.SpanRaws(fb.blob, fb.spans)
    whole = framing.unpack_batch(frames[0]) + framing.unpack_batch(frames[1])
    assert len(raws) == len(fb)
    assert raws[5] == whole[5] and raws[np.int64(600)] == whole[600]
    part = raws[510:515]
    assert isinstance(part, matchkern.SpanRaws) and len(part) == 5
    assert [part[i] for i in range(5)] == whole[510:515]
