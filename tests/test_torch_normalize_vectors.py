"""The normalize kernel's partition (K6) in plain numpy/torch, on the CPU.

csrc/frame_ops.cu normalizes uint8 frames in vectors of V elements that
follow the output (V = 8 for bf16 out, 4 for float32: one 16-byte store
a vector): one aligned V-byte load a vector where the input starts on V
bytes; else, for an input m bytes past a V-byte boundary, the vector's
two aligned words from its aligned start, shifted right by m bytes; the
elements past the last whole vector one at a time. Element V v + e has
colour (p + e) % 3 with p = V v % 3. `normalize_vectors` below is that
partition on a byte buffer; here it is held bit for bit to
normalize_frames_reference, in float32 and bf16, at element counts that
are not multiples of 48 or 16 and inputs 0-15 bytes past a 16-byte
boundary, and it checks that every aligned word it loads holds a byte of
the input (so the kernel never reads a word outside its input's).
"""

import numpy as np
import pytest
import torch

from video_chapter_generation_tpu_torch.ops.preprocess import (
    affine_consts,
    normalize_frames_reference,
)


def normalize_vectors(buf: np.ndarray, off: int, n: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's partition of the n bytes buf[off:off + n] (buf's index
    0 is 16-byte aligned) -> [n] normalized out_dtype."""
    a, b = (t.numpy() for t in affine_consts())
    width = 8 if out_dtype == torch.bfloat16 else 4
    m, base = off % width, off - off % width
    padded = np.zeros(len(buf) + 2 * width, np.uint8)
    padded[:len(buf)] = buf
    words = lambda i: int.from_bytes(  # noqa: E731
        padded[base + width * i:base + width * i + width].tobytes(),
        "little")
    vals = np.zeros(n, np.uint32)
    cols = np.zeros(n, np.int64)
    vecs = n // width
    for v in range(vecs):
        w = words(v)
        if m:
            hi = base + width * (v + 1)
            assert hi < off + n  # the second word holds an input byte
            w = ((words(v + 1) << (8 * width)) | w) >> (8 * m)
        p = (v % 3) * (width % 3) % 3
        for e in range(width):
            vals[width * v + e] = (w >> (8 * e)) & 0xFF
            cols[width * v + e] = (p + e % 3) % 3
    vals[width * vecs:] = buf[off + width * vecs:off + n]
    cols[width * vecs:] = np.arange(width * vecs, n) % 3
    u = torch.from_numpy(vals.astype(np.float32))
    c = torch.from_numpy(cols)
    out = u * torch.from_numpy(a)[c] + torch.from_numpy(b)[c]
    return out.to(out_dtype)


# (pixels, offset): fewer than one vector, counts off 48 and 16, many
# vectors; inputs 0-15 bytes past a 16-byte boundary
CASES = [(1, 3), (5, 0), (16, 3), (17, 1), (123, 5), (1000, 7), (683, 12),
         (512, 15), (97, 4), (1024, 0)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pixels,off", CASES)
def test_normalize_vectors_is_the_reference(pixels, off, out_dtype):
    n = 3 * pixels
    buf = np.random.default_rng(pixels + off).integers(
        0, 256, off + n + 5).astype(np.uint8)
    got = normalize_vectors(buf, off, n, out_dtype)
    frames = torch.from_numpy(buf[off:off + n].copy()).view(pixels, 3)
    want = normalize_frames_reference(frames, out_dtype).reshape(-1)
    assert torch.equal(got, want)
