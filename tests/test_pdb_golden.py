"""Hand-assembled `.pdb` golden (VERDICT r4 item 4).

No Rust toolchain exists on this box to run `pgr-pbundle-decomp` and
produce a reference-written `.pdb`, so this golden is derived BYTE BY
BYTE from the bincode-2 "standard config" specification (little-endian,
varint integers) and the reference's exact tuple layout
(pgr-bin/src/bin/pgr-pbundle-decomp.rs:169-218, 357-383):

    "PDB:0.5" ++ bincode(
        (w: u32, k: u32, r: u32, min_span: u32,
         min_branch_size: usize, min_cov: usize,
         Vec<(usize, usize, Vec<(u64, u64, u8)>)>,    # bundles
         FxHashMap<(u64, u64), (usize, u8, usize)>))  # vertex map

bincode-2 varint: v < 251 -> 1 byte; <= u16::MAX -> 0xFB + u16le;
<= u32::MAX -> 0xFC + u32le; else 0xFD + u64le.  u8 is a raw byte.
Vec and HashMap are length-prefixed (varint count ++ entries).

The bytes below are assembled with explicit byte literals — NOT via
core.bincodec — so the test is an independent derivation of the spec;
it cross-checks the reader AND the writer against it.  The committed
copy (tests/data/golden.pdb) pins the byte stream against codec drift.

The one intentional divergence: the reference writes the vertex map in
FxHashMap iteration order (nondeterministic); the golden and our writer
use sorted key order.  Both readers accept any entry order (a HashMap
decode is order-free), so cross-compat is unaffected.
"""
import os

from pgrtk.core import pdb_io

GOLDEN_PATH = os.path.join(
    os.path.dirname(__file__), "data", "golden.pdb"
)


def u16le(v):
    return b"\xfb" + v.to_bytes(2, "little")


def u32le(v):
    return b"\xfc" + v.to_bytes(4, "little")


def u64le(v):
    return b"\xfd" + v.to_bytes(8, "little")


def build_golden_bytes() -> bytes:
    # header scalars: w=48 k=56 r=4 min_span=12 (u32 varints),
    # min_branch_size=8 min_cov=2 (usize varints) — all < 251, 1 byte
    blob = b"\x30" + b"\x38" + b"\x04" + b"\x0c" + b"\x08" + b"\x02"

    # bundles: Vec of 2
    blob += b"\x02"
    # bundle A: bid=0, order=300 (251 <= 300 <= u16::MAX -> 0xFB),
    # path of 3 vertices covering every varint width
    blob += b"\x00"
    blob += u16le(300)
    blob += b"\x03"
    #   (0xDEADBEEF12345678, 0x0123456789ABCDEF, 0)
    blob += u64le(0xDEADBEEF12345678) + u64le(0x0123456789ABCDEF) + b"\x00"
    #   (251, 65535, 1): both need the 0xFB escape (251 is the cutoff)
    blob += u16le(251) + u16le(65535) + b"\x01"
    #   (2^32, 250, 0): first needs 0xFD (> u32::MAX), 250 is the last
    #   single-byte value
    blob += u64le(1 << 32) + b"\xfa" + b"\x00"
    # bundle B: bid=1, order=usize::MAX (unvisited-bundle sentinel,
    # ext.rs:609), path of 1
    blob += b"\x01"
    blob += u64le(2**64 - 1)
    blob += b"\x01"
    #   (65536, 4294967295, 1): 0xFC boundary cases
    blob += u32le(65536) + u32le(4294967295) + b"\x01"

    # vertex map: 2 entries in sorted key order
    blob += b"\x02"
    #   (251, 65535) -> (bid=0, dir=1, pos=5)
    blob += u16le(251) + u16le(65535) + b"\x00" + b"\x01" + b"\x05"
    #   (2^32, 250) -> (bid=1, dir=0, pos=300)
    blob += u64le(1 << 32) + b"\xfa" + b"\x01" + b"\x00" + u16le(300)

    return b"PDB:0.5" + blob


EXPECT_BUNDLES = [
    (0, 300, [
        (0xDEADBEEF12345678, 0x0123456789ABCDEF, 0),
        (251, 65535, 1),
        (1 << 32, 250, 0),
    ]),
    (1, 2**64 - 1, [(65536, 4294967295, 1)]),
]
EXPECT_VMAP = {
    (251, 65535): (0, 1, 5),
    (1 << 32, 250): (1, 0, 300),
}


def test_committed_golden_matches_spec_bytes():
    """The committed golden must be exactly the spec-derived stream."""
    with open(GOLDEN_PATH, "rb") as f:
        assert f.read() == build_golden_bytes()


def test_reader_parses_hand_assembled_golden():
    got = pdb_io.read_pdb(GOLDEN_PATH)
    w, k, r, min_span, min_branch_size, min_cov, bundles, vmap = got
    assert (w, k, r, min_span) == (48, 56, 4, 12)
    assert (min_branch_size, min_cov) == (8, 2)
    assert bundles == EXPECT_BUNDLES
    assert vmap == EXPECT_VMAP


def test_writer_reproduces_golden_bytes(tmp_path):
    """write_pdb on the golden's content must emit the byte-identical
    stream (sorted vertex-map order is the writer's canonical order and
    the golden's)."""
    out = tmp_path / "roundtrip.pdb"
    pdb_io.write_pdb(
        str(out), 48, 56, 4, 12, 8, 2, EXPECT_BUNDLES, EXPECT_VMAP
    )
    assert out.read_bytes() == build_golden_bytes()
