"""Read the x86 ``rsqrtps`` estimates of this host's CPU and hold them
against ``ops.xla_f32.RSQRT_TABLE`` (XLA:CPU's float32 ``rsqrt`` refines
that estimate; the table is Intel's, and an AMD core's differs):

    python -m hipsc_abm_tpu_torch.tools.rsqrt_table [--print]

Compiles a small C program with the host's ``cc`` (SSE intrinsics) into
``hipsc_abm_tpu_torch/_build/``, evaluates ``_mm_rsqrt_ss`` at every float32
in [1, 4) and checks that it depends only on the exponent's parity and the
top 10 mantissa bits, then compares the 2048 12-bit mantissas with the
table (exit 0 when equal). ``--print`` prints them as the table's lines.
"""

import subprocess
import sys

import numpy as np

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import xla_f32

C_SOURCE = r"""
#include <immintrin.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
int main(void) {
  for (uint32_t i = 0; i < (1u << 24); ++i) {
    uint32_t bits = (127u << 23) + i, out;
    float x, y;
    memcpy(&x, &bits, 4);
    y = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x)));
    memcpy(&out, &y, 4);
    fwrite(&out, 4, 1, stdout);
  }
  return 0;
}
"""


def host_table() -> np.ndarray:
    """(2048,) the host's 12-bit estimate mantissas, by index (exponent
    parity << 10 | top 10 mantissa bits)."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, exe = kernels.BUILD_DIR / "rsqrt_probe.c", kernels.BUILD_DIR / "rsqrt_probe"
    src.write_text(C_SOURCE)
    subprocess.run(["cc", "-O1", "-msse", "-o", str(exe), str(src)], check=True)
    out = np.frombuffer(subprocess.run([str(exe)], check=True, capture_output=True).stdout,
                        dtype=np.uint32).reshape(2048, 8192)
    if not (out == out[:, :1]).all():
        raise SystemExit("the estimate depends on more than 11 input bits")
    if not ((out[:, 0] >> 23) == 126).all() or (out[:, 0] & 0x7FF).any():
        raise SystemExit("the estimates are not 12-bit mantissas in [0.5, 1)")
    return (out[:, 0] >> 11) & 0xFFF


def main(argv) -> int:
    got = host_table()
    if "--print" in argv:
        digits = "".join(f"{v:03x}" for v in got)
        print("\n".join(f'    "{digits[i:i + 72]}"' for i in range(0, len(digits), 72)))
    want = xla_f32.rsqrt_table("cpu").numpy()
    same = bool(np.array_equal(got, want))
    print(f"rsqrt_table: host estimates {'equal' if same else 'differ from'} RSQRT_TABLE"
          f"{'' if same else f' at {int((got != want).sum())} of 2048 entries'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
