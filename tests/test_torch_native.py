"""The port's host C++ library (``qrec_tpu_torch/csrc/qrec_host.cpp``,
bound in ``qrec_tpu_torch/native.py``) against the JAX package's
(``native/qrec_native.cpp``, ``qrec_tpu.native``), on the CPU: the
tokenizer's ids, names and float32 ratings bit for bit on files with a
header, mixed space/comma/tab delimiters, runs of delimiters, ratings that
float32 rounds, binarize and a missing rating column; CRLF files (on which
the JAX library loops forever: its LF twin is the reference there); the
malformed-line ``DataFormatError`` where the JAX library skips the line or
reads 0; ``io.load_ratings`` against the JAX package's and against the
plain regex parser; the walker bit for bit against
``random_walks_native`` on weighted graphs with isolated nodes; and a
failed build raising with the compiler's output."""

import numpy as np
import pytest
import scipy.sparse as sp

from qrec_tpu import config as jconfig
from qrec_tpu import io as jio
from qrec_tpu import native as jnative
from qrec_tpu_torch import config as tconfig
from qrec_tpu_torch import io as tio
from qrec_tpu_torch import native
from qrec_tpu_torch.errors import DataFormatError

BODY = (
    "u1 i1 4.5\n"
    "u2,i1,0.7\n"
    "u1\ti3\t3.3\n"
    "u3 , i2,\t1\n"  # a run of delimiters is one
    "u2 i4 2.9999999\n"  # float32 rounds it to 3
    "u4 i3 5 extra\n"
)
CASES = [
    # (u, i, r, binarize, threshold, header)
    (0, 1, 2, False, 0.0, False),
    (0, 1, 2, True, 3.0, False),
    (0, 1, 2, True, 0.5, False),
    (0, 1, -1, False, 0.0, False),
    (0, 1, -1, True, 3.0, False),  # binarize with no rating column: every rating 1 < 3
    (0, 1, -1, True, 1.0, False),
    (1, 0, 2, False, 0.0, False),
    (0, 1, 2, False, 0.0, True),
]


def _parsed_equal(got, want):
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert list(got[3]) == list(want[3]) and list(got[4]) == list(want[4])


@pytest.mark.parametrize("case", CASES)
def test_tokenizer_equals_jax_native(tmp_path, case):
    u, i, r, binarize, threshold, header = case
    path = tmp_path / "r.txt"
    path.write_text(("user item rating\n" if header else "") + BODY)
    kw = dict(binarize=binarize, threshold=threshold, skip_header=header)
    got = native.parse_ratings(str(path), u, i, r, **kw)
    want = jnative.parse_ratings_native(str(path), u, i, r, **kw)
    _parsed_equal(got, want)
    if r >= 0 and not binarize:
        assert got.ratings[1] == np.float32(0.7) and got.ratings[4] == np.float32(3.0)


@pytest.mark.parametrize("header", [False, True])
def test_tokenizer_reads_crlf_as_its_lf_twin(tmp_path, header):
    """The JAX library never returns on a CRLF file (its token loop stops
    at the '\\r' without passing it); the port's skips it, so a CRLF file
    parses as its LF twin does in the JAX library."""
    text = ("user item rating\n" if header else "") + BODY
    crlf, lf = tmp_path / "crlf.txt", tmp_path / "lf.txt"
    crlf.write_bytes(text.replace("\n", "\r\n").encode())
    lf.write_text(text)
    got = native.parse_ratings(str(crlf), 0, 1, 2, skip_header=header)
    _parsed_equal(got, jnative.parse_ratings_native(str(lf), 0, 1, 2, skip_header=header))
    # and as the plain parser reads it (universal newlines, stripped lines)
    simple = tmp_path / "simple.txt"
    simple.write_bytes(b"u1 i1 4.5\r\nu2,i1,0.7\r\nu1\ti3\t3\r\n")
    conf = tconfig.ModelConf({"ratings.setup": "-columns 0 1 2"})
    plain = tio.parse_ratings_plain(str(simple), 0, 1, 2)
    assert tio.load_ratings(conf, str(simple)) == [[a, b, float(np.float32(c))] for a, b, c in plain]


def test_tokenizer_on_a_larger_file_equals_jax_native(tmp_path):
    rng = np.random.RandomState(0)
    rows = [f"{rng.randint(900)}{rng.choice([' ', ',', chr(9)])}{rng.randint(1500)} "
            f"{rng.randint(1, 11) / 2}\n" for _ in range(20000)]
    path = tmp_path / "big.txt"
    path.write_text("".join(rows))
    got = native.parse_ratings(str(path), 0, 1, 2)
    _parsed_equal(got, jnative.parse_ratings_native(str(path), 0, 1, 2))
    assert len(got.users) == 20000 and len(got.user_names) == got.users.max() + 1


@pytest.mark.parametrize(
    "text,columns,line",
    [
        ("u1 i1 4\nu2 i2\nu3 i3 1\n", "-columns 0 1 2", 1),  # too few tokens
        ("u1 i1 4\nu2 i2 abc\n", "-columns 0 1 2", 1),  # no number (the JAX library reads 0)
        ("u1 i1 4\nu2 i2 4x\n", "-columns 0 1 2", 1),  # a number and more (JAX: 4)
        ("user item r\nu1 i1 4\n", "-columns 0 1 2", 0),  # a header without -header
        ("h\nu1 i1 4\n\nu2 i2 1\n", "-columns 0 1 2 -header", 1),  # a blank line
        ("u1\n", "-columns 0 1", 0),
    ],
)
def test_malformed_line_raises_as_the_plain_parser_does(tmp_path, text, columns, line):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    conf = tconfig.ModelConf({"ratings.setup": columns})
    with pytest.raises(DataFormatError, match=f"Malformed rating line {line} in ") as native_err:
        tio.load_ratings(conf, str(path))
    order = [int(c) for c in columns.split()[1:] if c.lstrip("-").isdigit()]
    with pytest.raises(DataFormatError) as plain_err:
        tio.parse_ratings_plain(str(path), order[0], order[1], order[2] if len(order) > 2 else -1,
                                header="-header" in columns)
    assert str(native_err.value) == str(plain_err.value)


@pytest.mark.parametrize(
    "setup,binarized,threshold",
    [("-columns 0 1 2 -header", False, 0.0), ("-columns 0 1 2 -header", True, 3.0),
     ("-columns 0 1 -header", False, 0.0), ("-columns 1 0 2 -header", False, 0.0)],
)
def test_load_ratings_equals_jax_and_the_plain_parser(tmp_path, setup, binarized, threshold):
    """Through the tokenizer the records equal the JAX package's (its
    native route); the plain parser gives the same records on ratings that
    float32 holds exactly."""
    path = tmp_path / "r.txt"
    path.write_text("user item rating\n" + "".join(
        f"u{u}\ti{(u * 7) % 11},{r}\n" for u in range(30) for r in (1, 3.5, 5)))
    t = tio.load_ratings(tconfig.ModelConf({"ratings.setup": setup}), str(path), binarized, threshold)
    j = jio.load_ratings(jconfig.ModelConf({"ratings.setup": setup}), str(path), binarized, threshold)
    assert t == j and len(t) > 0
    order = [int(c) for c in setup.split()[1:] if c.isdigit()]
    plain = tio.parse_ratings_plain(str(path), order[0], order[1], order[2] if len(order) > 2 else -1,
                                    binarized, threshold, header=True)
    assert t == plain


def test_custom_delimiter_takes_the_plain_parser(tmp_path, monkeypatch):
    path = tmp_path / "r.txt"
    path.write_text("u1;i1;4\nu2;i2;0.7\n")
    monkeypatch.setattr(native, "parse_ratings", None)  # never called
    got = tio.load_ratings(tconfig.ModelConf({"ratings.setup": "-columns 0 1 2 -delim ;"}), str(path))
    assert got == [["u1", "i1", 4.0], ["u2", "i2", 0.7]]


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_ratings(str(tmp_path / "none.txt"), 0, 1, 2)


def _graph(n, density, seed, isolated):
    a = sp.random(n, n, density=density, random_state=seed, format="csr", dtype=np.float32)
    a.data = np.round(a.data * 9 + 1)  # integer weights 1..10, as co-rating counts
    return sp.block_diag([a, sp.csr_matrix((isolated, isolated), dtype=np.float32)]).tocsr()


@pytest.mark.parametrize(
    "n,density,seed,isolated,count,length",
    [(40, 0.15, 0, 3, 5, 8), (200, 0.02, 1, 0, 10, 10), (30, 0.05, 2, 5, 3, 1), (60, 0.3, 3, 1, 2, 20)],
)
def test_walker_equals_jax_native(n, density, seed, isolated, count, length):
    net = _graph(n, density, seed, isolated)
    active = np.where(np.diff(net.indptr) > 0)[0].astype(np.int32)
    cum = np.cumsum(net.data.astype(np.float64))
    starts = np.repeat(active, count)
    for walk_seed in (0, 12345, 2**31 - 1):
        got = native.random_walks(net.indptr, net.indices, cum, starts, length, walk_seed)
        want, want_active = jnative.random_walks_native(net, count, length, walk_seed)
        np.testing.assert_array_equal(active, want_active)
        np.testing.assert_array_equal(got, want)
    assert not np.isin(np.arange(n, n + isolated), got).any()


def test_walker_stays_on_a_node_without_edges():
    net = sp.csr_matrix(np.array([[0, 1, 0], [0, 0, 0], [1, 0, 0]], dtype=np.float32))
    cum = np.cumsum(net.data.astype(np.float64))
    walks = native.random_walks(net.indptr, net.indices, cum, np.array([0, 2]), 4, 7)
    np.testing.assert_array_equal(walks, [[0, 1, 1, 1], [2, 0, 1, 1]])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "qrec_host.cpp"
    broken.write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build qrec_host.cpp") as err:
        native.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_is_named_by_source_and_flags(tmp_path, monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("qrec_host-")
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
    assert native.library_path() != path
    # the port's own source, not the JAX package's native/ library
    assert native.SOURCE.name == "qrec_host.cpp" and native.SOURCE.parent.name == "csrc"


def test_walker_refuses_inconsistent_arrays():
    net = sp.csr_matrix(np.array([[0, 1], [1, 0]], dtype=np.float32))
    cum = np.cumsum(net.data.astype(np.float64))
    for args in ((net.indptr, net.indices, cum[:1], [0], 3), (net.indptr, net.indices, cum, [2], 3),
                 (net.indptr, net.indices, cum, [0], 0), (net.indptr, [0, 5], cum, [0], 3)):
        with pytest.raises(ValueError, match="square CSR graph"):
            native.random_walks(*args, seed=1)
