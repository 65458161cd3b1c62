"""The port's int and UTF-8 vector codecs (filodb_tpu_torch/memory/
{intvec,utf8vec}.py) against the JAX package's: the same seeded inputs
encode to the same bytes, and each package decodes the other's."""
import numpy as np
import pytest

from filodb_tpu.memory import intvec as ref_intvec
from filodb_tpu.memory import utf8vec as ref_utf8vec
from filodb_tpu_torch.memory import intvec, utf8vec


def _ints(seed, span_bits, n=1000):
    rng = np.random.default_rng(seed)
    base = int(rng.integers(-(1 << 40), 1 << 40))
    return base + rng.integers(0, (1 << span_bits) if span_bits else 1,
                               size=n).astype(np.int64)


@pytest.mark.parametrize("span_bits", [0, 1, 2, 3, 7, 9, 15, 17, 31, 40, 62])
@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_pack_ints_bytes_equal_the_reference(span_bits, n):
    vals = _ints(16 + span_bits, span_bits, n)
    enc = intvec.pack_ints(vals)
    assert enc == ref_intvec.pack_ints(vals)
    assert intvec.packed_width_bits(enc) == ref_intvec.packed_width_bits(enc)
    np.testing.assert_array_equal(intvec.unpack_ints(enc, n), vals)
    np.testing.assert_array_equal(
        intvec.unpack_ints(ref_intvec.pack_ints(vals), n),
        ref_intvec.unpack_ints(enc, n))


@pytest.mark.parametrize("valid_frac", [0.0, 0.3, 1.0])
def test_pack_ints_masked_bytes_equal_the_reference(valid_frac):
    rng = np.random.default_rng(161)
    vals = rng.integers(-500, 500, 333).astype(np.int64)
    valid = rng.random(333) < valid_frac
    enc = intvec.pack_ints_masked(vals, valid)
    assert enc == ref_intvec.pack_ints_masked(vals, valid)
    got, got_valid = intvec.unpack_ints_masked(enc, 333)
    want, want_valid = ref_intvec.unpack_ints_masked(enc, 333)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_valid, want_valid)
    np.testing.assert_array_equal(got[valid], vals[valid])


def _strings(rng, n, card):
    pool = [f"App-{i}".encode() for i in range(card)] + ["", "ü"]
    pool = [p if isinstance(p, bytes) else p.encode() for p in pool]
    return [pool[i] for i in rng.integers(0, len(pool), n)]


@pytest.mark.parametrize("n, card", [(0, 1), (1, 1), (500, 3), (2000, 700)])
def test_utf8_and_dict_bytes_equal_the_reference(n, card):
    rng = np.random.default_rng(162 + n)
    strings = _strings(rng, n, card)
    blob = utf8vec.pack_utf8(strings)
    assert blob == ref_utf8vec.pack_utf8(strings)
    assert utf8vec.unpack_utf8(blob) == ref_utf8vec.unpack_utf8(blob)
    enc = utf8vec.pack_dict_utf8(strings)
    assert enc == ref_utf8vec.pack_dict_utf8(strings)
    assert utf8vec.unpack_dict_utf8(enc) == strings
    assert utf8vec.dict_cardinality(enc) == \
        ref_utf8vec.dict_cardinality(enc) == len(set(strings))


def test_label_table_bytes_equal_the_reference():
    rng = np.random.default_rng(163)
    rows = []
    for i in range(400):
        r = {"_ws_": "demo", "_ns_": f"App-{i % 13}",
             "instance": f"Instance-{i}", "_metric_": "request_total"}
        if rng.random() < 0.2:
            r["le"] = ""                # present but empty
        if rng.random() < 0.3:
            del r["instance"]           # absent
        rows.append(r)
    enc = utf8vec.pack_label_table(rows)
    assert enc == ref_utf8vec.pack_label_table(rows)
    assert utf8vec.unpack_label_table(enc) == rows
    assert ref_utf8vec.unpack_label_table(enc) == rows
    assert utf8vec.pack_label_table([]) == ref_utf8vec.pack_label_table([])
