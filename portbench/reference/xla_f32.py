"""Float32 arithmetic as XLA:CPU compiles the JAX package, mirrored in
eager PyTorch so that the CPU and the card give the same bits as the JAX
package on an x86-64 machine with FMA (Intel cores, jax 0.9, glibc 2.36).

What XLA:CPU does that eager PyTorch does not, read from the object code of
the JAX engine's compiled step (``XLA_FLAGS=--xla_dump_to=DIR``, then
``objdump -d`` of the fusions' object files; the IR names no FMA):

- its LLVM backend fuses a multiply into the add that consumes it when the
  product has no other use: ``dx * dx + dy * dy`` becomes
  ``fma(dx, dx, dy * dy)``, a three-term ``jnp.sum`` of squares
  ``fma(v2, v2, fma(v1, v1, v0 * v0))``, the Stokes update
  ``loc + (dt v) 1e6`` one FMA (``fma``);
- ``rsqrt`` is the hardware estimate ``rsqrtps`` refined by two Newton
  steps with FMAs (``rsqrt``); the estimate is a table of 2048 12-bit
  values on Intel cores (``RSQRT_TABLE``), indexed by the input's exponent
  parity and top 10 mantissa bits;
- the algebraic simplifier folds constants: ``x / c`` becomes
  ``x * (1 / c)`` (``recip``), and ``(x * c1) * c2`` becomes ``x * (c1 * c2)`` with the
  constant product rounded to float32 (``fold``).

Each mirror is float32/float64 arithmetic with integer and bit operations,
so it runs on either device; ``fma`` and ``rsqrt`` carry their own backward
(the plain formula's derivative), since autograd does not pass the bit
operations.
"""

from __future__ import annotations

import numpy as np
import torch

from .rng import fma_f32, sqrt_f32


def f32(v):
    """``v`` rounded to float32 (a Python float holding a float32 value);
    a tensor (a parameter autograd differentiates, which XLA sees as a
    traced value, not a constant) is returned as it is."""
    return v if isinstance(v, torch.Tensor) else float(np.float32(v))


def recip(c: float) -> float:
    """The float32 reciprocal of a float32 constant, by which XLA:CPU
    replaces a division by it."""
    return float(np.float32(1.0) / np.float32(c))


def fold(*constants):
    """The float32 product of float32 constants, rounded after each
    multiply, as XLA's constant folding forms ``(x * c1) * c2``; with a
    tensor among them (a traced value to XLA, which folds nothing), the
    product of them all in order."""
    if any(isinstance(c, torch.Tensor) for c in constants):
        out = constants[0]
        for c in constants[1:]:
            out = out * c
        return out
    out = np.float32(constants[0])
    for c in constants[1:]:
        out = np.float32(out * np.float32(c))
    return float(out)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 rounded once (``rng.fma_f32``, float64
    operations on any device). ``b`` and ``c`` may be floats, rounded to
    float32 first."""
    b, c = f32(b), f32(c)  # a float operand is a float32 constant
    return fma_f32(a, b, c)


class _Sqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = sqrt_f32(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * 0.5 / y


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (``rng.sqrt_f32``; XLA:CPU
    emits ``sqrtps``), with the derivative of ``sqrt``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Sqrt.apply(x)
    return sqrt_f32(x)


def sq_sum(dx: torch.Tensor, dy: torch.Tensor, dz=None) -> torch.Tensor:
    """``dx * dx + dy * dy (+ dz * dz)`` as XLA:CPU computes the TPU
    kernels' squared distance: ``fma(dz, dz, fma(dx, dx, dy * dy))``."""
    s = fma(dx, dx, dy * dy)
    return s if dz is None else fma(dz, dz, s)


def row_sq_sum(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(v * v, axis=-1)`` of (..., 3) rows as XLA:CPU computes it:
    ``fma(v2, v2, fma(v1, v1, v0 * v0))``."""
    return fma(v[..., 2], v[..., 2], fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0]))


# the estimates of x86 ``rsqrtps`` on Intel cores: entry i, for an input
# whose unbiased exponent has parity i >> 10 and whose top 10 mantissa bits
# are i & 1023, is the 12-bit mantissa of the estimate in [0.5, 1) of
# 1 / sqrt(x) scaled into [1, 4); read with ``tools/rsqrt_table.py``
RSQRT_TABLE = (
    "ffeffaff6ff2feefeafe6fe2fdefdafd6fd2fcefcbfc7fc3fbffbbfb7fb3faffabfa7fa4"
    "fa0f9cf98f94f90f8cf89f85f81f7df79f76f72f6ef6af66f63f5ff5bf57f54f50f4cf48"
    "f45f41f3df39f36f32f2ef2bf27f23f20f1cf18f15f11f0df0af06f02effefbef7ef4ef0"
    "eedee9ee5ee2edeedbed7ed3ed0eccec9ec5ec2ebeebaeb7eb3eb0eacea9ea5ea2e9ee9b"
    "e97e94e90e8de89e86e82e7fe7be78e75e71e6ee6ae67e63e60e5de59e56e52e4fe4ce48"
    "e45e41e3ee3be37e34e31e2de2ae26e23e20e1ce19e16e12e0fe0ce09e05e02dffdfbdf8"
    "df5df1deedebde8de4de1ddeddbdd7dd4dd1dcedcadc7dc4dc1dbedbadb7db4db1daedaa"
    "da7da4da1d9ed9bd97d94d91d8ed8bd88d84d81d7ed7bd78d75d72d6fd6bd68d65d62d5f"
    "d5cd59d56d53d50d4dd49d46d43d40d3dd3ad37d34d31d2ed2bd28d25d22d1fd1cd19d16"
    "d13d10d0dd0ad07d04d01cfecfbcf8cf5cf2cefcecce9ce6ce3ce0cddcdbcd8cd5cd2ccf"
    "ccccc9cc6cc3cc0cbdcbacb8cb5cb2cafcacca9ca6ca3ca1c9ec9bc98c95c92c8fc8dc8a"
    "c87c84c81c7ec7cc79c76c73c70c6ec6bc68c65c62c60c5dc5ac57c54c52c4fc4cc49c47"
    "c44c41c3ec3cc39c36c33c31c2ec2bc28c26c23c20c1ec1bc18c15c13c10c0dc0bc08c05"
    "c03c00bfdbfbbf8bf5bf3bf0bedbebbe8be5be3be0bddbdbbd8bd5bd3bd0bcebcbbc8bc6"
    "bc3bc0bbebbbbb9bb6bb3bb1baebacba9ba7ba4ba1b9fb9cb9ab97b95b92b8fb8db8ab88"
    "b85b83b80b7eb7bb79b76b73b71b6eb6cb69b67b64b62b5fb5db5ab58b55b53b50b4eb4b"
    "b49b46b44b41b3fb3db3ab38b35b33b30b2eb2bb29b26b24b22b1fb1db1ab18b15b13b11"
    "b0eb0cb09b07b05b02b00afdafbaf9af6af4af1aefaedaeaae8ae5ae3ae1adeadcadaad7"
    "ad5ad3ad0aceacbac9ac7ac4ac2ac0abdabbab9ab6ab4ab2aafaadaabaa8aa6aa4aa2a9f"
    "a9da9ba98a96a94a91a8fa8da8ba88a86a84a82a7fa7da7ba78a76a74a72a6fa6da6ba69"
    "a66a64a62a60a5da5ba59a57a55a52a50a4ea4ca49a47a45a43a41a3ea3ca3aa38a36a33"
    "a31a2fa2da2ba28a26a24a22a20a1da1ba19a17a15a13a10a0ea0ca0aa08a06a04a019ff"
    "9fd9fb9f99f79f59f29f09ee9ec9ea9e89e69e49e19df9dd9db9d99d79d59d39d19ce9cc"
    "9ca9c89c69c49c29c09be9bc9ba9b79b59b39b19af9ad9ab9a99a79a59a39a199f99d99b"
    "99999799499299098e98c98a98898698498298097e97c97a97897697497297096e96c96a"
    "96896696496296095e95c95a95895695495295094e94c94a94894694494294093e93c93a"
    "93893793593393192f92d92b92992792592392191f91d91b91991791691491291090e90c"
    "90a9089069049029008ff8fd8fb8f98f78f58f38f18ef8ed8ec8ea8e88e68e48e28e08de"
    "8dc8db8d98d78d58d38d18cf8ce8cc8ca8c88c68c48c28c18bf8bd8bb8b98b78b58b48b2"
    "8b08ae8ac8aa8a98a78a58a38a189f89e89c89a89889689589389188f88d88c88a888886"
    "88488388187f87d87b87a87887687487287186f86d86b86a86886686486286185f85d85b"
    "85a85885685485385184f84d84c84a84884684584384183f83e83c83a838837835833831"
    "83082e82c82b82982782582482282081f81d81b81981881681481381180f80d80c80a808"
    "8078058038028007fe7fd7fb7f97f77f67f47f27f17ef7ed7ec7ea7e87e77e57e37e27e0"
    "7de7dd7db7d97d87d67d47d37d17d07ce7cc7cb7c97c77c67c47c27c17bf7be7bc7ba7b9"
    "7b77b57b47b27b07af7ad7ac7aa7a87a77a57a47a27a079f79d79b79a798797795793792"
    "79078f78d78b78a78878778578478278077f77d77c77a77877777577477277176f76d76c"
    "76a76976776676476276175f75e75c75b75975875675475375175074e74d74b74a748747"
    "74574474274073f73d73c73a73973773673473373173072e72d72b72a728727725723722"
    "72071f71d71c71a71971771671471371171070e70d70b70a7087077057047037017006fe"
    "6fd6fb6fa6f86f76f56f46f26f16ef6ee6ec6eb6e96e86e66e56e46e26e16df6de6dc6db"
    "6d96d86d66d56d36d26d16cf6ce6cc6cb6c96c86c66c56c46c26c16bf6be6bc6bb6ba6b8"
    "6b76b56b46b26b16b06ae6ad6ab6aa6a86a76a66a46a36a169f69c69a69769469168e68c"
    "68968668368067e67b67867567367066d66a66766566265f65d65a65765465264f64c64a"
    "64764464163f63c63963763463162f62c62962762462161f61c61961761461260f60c60a"
    "6076056025ff5fd5fa5f85f55f25f05ed5eb5e85e65e35e05de5db5d95d65d45d15cf5cc"
    "5ca5c75c45c25bf5bd5ba5b85b55b35b05ae5ab5a95a75a45a259f59d59a598595593590"
    "58e58b58958758458257f57d57a57857657357156e56c56a56756556256055e55b559557"
    "55455254f54d54b54854654454153f53d53a53853653353152f52c52a52852552352151e"
    "51c51a51851551351150e50c50a5085055035014ff4fc4fa4f84f64f34f14ef4ed4ea4e8"
    "4e64e44e14df4dd4db4d94d64d44d24d04ce4cb4c94c74c54c34c04be4bc4ba4b84b64b3"
    "4b14af4ad4ab4a94a64a44a24a049e49c49a49749549349148f48d48b489486484482480"
    "47e47c47a47847647447146f46d46b46946746546346145f45d45b45945745545245044e"
    "44c44a44844644444244043e43c43a43843643443243042e42c42a42842642442242041e"
    "41c41a41841641441241040e40c40a4084064044024003fe3fd3fb3f93f73f53f33f13ef"
    "3ed3eb3e93e73e53e33e13e03de3dc3da3d83d63d43d23d03ce3cc3cb3c93c73c53c33c1"
    "3bf3bd3bc3ba3b83b63b43b23b03ae3ad3ab3a93a73a53a33a13a039e39c39a398396395"
    "39339138f38d38b38a38838638438238137f37d37b37937837637437237036f36d36b369"
    "36736636436236035e35d35b35935735635435235034f34d34b34934834634434234133f"
    "33d33b33a33833633433333132f32e32c32a32832732532332232031e31c31b319317316"
    "31431231130f30d30b30a3083063053033013002fe2fc2fb2f92f72f62f42f22f12ef2ed"
    "2ec2ea2e82e72e52e32e22e02df2dd2db2da2d82d62d52d32d12d02ce2cd2cb2c92c82c6"
    "2c52c32c12c02be2bc2bb2b92b82b62b42b32b12b02ae2ac2ab2a92a82a62a52a32a12a0"
    "29e29d29b29a29829629529329229028f28d28b28a28828728528428228127f27e27c27a"
    "27927727627427327127026e26d26b26a26826726526326226025f25d25c25a259257256"
    "25425325125024e24d24b24a24824724524424224123f23e23d23b23a238237235234232"
    "23122f22e22c22b22922822622522422222121f21e21c21b21921821621521421221120f"
    "20e20c20b20a2082072052042022012001fe1fd1fb1fa1f81f71f61f41f31f11f01ef1ed"
    "1ec1ea1e91e81e61e51e31e21e11df1de1dc1db1da1d81d71d51d41d31d11d01cf1cd1cc"
    "1ca1c91c81c61c51c41c21c11bf1be1bd1bb1ba1b91b71b61b51b31b21b01af1ae1ac1ab"
    "1aa1a81a71a61a41a31a21a019f19e19c19b19a19819719619419319219018f18e18c18b"
    "18a18818718618518318218117f17e17d17b17a17917717617517417217117016e16d16c"
    "16b16916816716516416316216015f15e15c15b15a15915715615515315215115014e14d"
    "14c14b14914814714614414314214113f13e13d13c13a13913813713513413313213012f"
    "12e12d12b12a12912812612512412312212011f11e11d11b11a119118117115114113112"
    "11010f10e10d10c10a1091081071061041031021011000fe0fd0fc0fb0fa0f80f70f60f5"
    "0f40f20f10f00ef0ee0ed0eb0ea0e90e80e70e50e40e30e20e10e00de0dd0dc0db0da0d9"
    "0d70d60d50d40d30d20d00cf0ce0cd0cc0cb0c90c80c70c60c50c40c30c10c00bf0be0bd"
    "0bc0bb0b90b80b70b60b50b40b30b10b00af0ae0ad0ac0ab0a90a80a70a60a50a40a30a2"
    "0a009f09e09d09c09b09a09909809609509409309209109008f08e08c08b08a089088087"
    "08608508408208108007f07e07d07c07b07a07907807607507407307207107006f06e06d"
    "06c06b06906806706606506406306206106005f05e05d05b05a059058057056055054053"
    "05205105004f04e04d04c04a04904804704604504404304204104003f03e03d03c03b03a"
    "03903803703603403303203103002f02e02d02c02b02a029028027026025024023022021"
    "02001f01e01d01c01b01a01901801701601501401301201101000f00e00d00c00b00a009"
    "008007006005004003002001"
)
_TABLES: dict = {}


def rsqrt_table(device) -> torch.Tensor:
    """``RSQRT_TABLE`` as a (2048,) int32 tensor on ``device`` (made once
    per device; the contact kernels read it through a pointer)."""
    device = torch.device(device)
    if device not in _TABLES:
        digits = "".join(RSQRT_TABLE)
        values = [int(digits[3 * i:3 * i + 3], 16) for i in range(len(digits) // 3)]
        _TABLES[device] = torch.tensor(values, dtype=torch.int32, device=device)
    return _TABLES[device]


def _rsqrt_estimate(x: torch.Tensor) -> torch.Tensor:
    """``rsqrtps`` of positive normal float32 ``x``: the table's mantissa
    under the exponent ``126 - floor(e / 2)`` of the unbiased exponent e."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 255) - 127
    index = ((e & 1) << 10) | ((bits >> 13) & 1023)
    m12 = rsqrt_table(x.device)[index.to(torch.int64)]
    return (((126 - (e >> 1)) << 23) | (m12 << 11)).view(torch.float32)


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _rsqrt_nr(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (-0.5 * y * y * y)


def _rsqrt_nr(x: torch.Tensor) -> torch.Tensor:
    y = _rsqrt_estimate(x)
    for _ in range(2):  # y + (-y / 2) (x y y - 1), the products fused
        y = fma_f32(y * -0.5, fma_f32(y, x * y, -1.0), y)
    return y


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``rsqrt`` of positive normal ``x`` (other inputs
    are the caller's to mask): the ``rsqrtps`` estimate y, then twice
    ``y = fma(y * -0.5, fma(y, x * y, -1), y)``."""
    x = x.to(torch.float32)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rsqrt.apply(x)
    return _rsqrt_nr(x)


# ---------------------------------------------------------------------------
# glibc's powf, which XLA:CPU calls for a float32 ``pow``
# ---------------------------------------------------------------------------

_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter of a float64


def _two_sum(a: torch.Tensor, b):
    """``(s, e)``: s = a + b rounded, e its exact error."""
    s = a + b
    t = s - a
    return s, (a - (s - t)) + (b - t)


def _split(a):
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def fma_f64(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in float64 rounded once, as the x86 ``vfmadd*sd`` (the
    card's ``__fma_rn``), for operands whose products and sums neither
    overflow nor underflow: the product split exactly into ``ph + pl``
    (Dekker), ``c + ph`` into ``sh + sl`` (TwoSum), ``sl + pl`` rounded to
    odd, and that added to ``sh`` (Boldo and Melquiond's emulation). ``b``
    and ``c`` may be floats."""
    a = a.to(torch.float64)
    ph = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - ph) + ah * bl + al * bh) + al * bl
    sh, sl = _two_sum(ph, c)
    v, err = _two_sum(sl, pl)
    # round to odd: step v toward zero where it lies beyond the exact sum,
    # then set its last bit where the sum was inexact
    beyond = (err * torch.sign(v) < 0).to(torch.int64)
    v = ((v.view(torch.int64) - beyond) | (err != 0).to(torch.int64)).view(torch.float64)
    return sh + v


def _hex64(*values: str) -> tuple:
    return tuple(float.fromhex(v) for v in values)


# glibc 2.36's __powf_log2_data (POWF_LOG2_TABLE_BITS = 4): 1 / c and
# log2(c) for the 16 subintervals of [0x3f330000, 2 x that) in float bits,
# and the polynomial of log2(1 + r); then __exp2f_data (EXP2F_TABLE_BITS =
# 5): 2^(i / 32) as float64 bits less i << 47, the shift that rounds y
# log2(x) to a multiple of 1 / 32, and the polynomial of 2^r. Read from
# libm.so.6's .rodata where __powf_fma addresses them (``objdump -d``).
_POWF_INVC = _hex64(
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010bp+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8eap+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0", "0x1p+0",
    "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aap-1", "0x1.b2036576afce6p-1",
    "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1", "0x1.767dcf5534862p-1")
_POWF_LOGC = _hex64(
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7afp-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5", "0x0p+0",
    "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3", "0x1.e840b4ac4e4d2p-3",
    "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2", "0x1.ce0a44eb17bccp-2")
_POWF_POLY = _hex64("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
                    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")
EXP2F_TABLE = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")
_EXP2F_POLY = _hex64("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")
# the float bits where the log2 table's subintervals start
_POWF_OFF = 0x3F330000


def _powf_tables(device) -> tuple:
    key = ("powf", torch.device(device))
    if key not in _TABLES:
        f64 = dict(dtype=torch.float64, device=device)
        _TABLES[key] = (torch.tensor(_POWF_INVC, **f64), torch.tensor(_POWF_LOGC, **f64),
                        torch.tensor(EXP2F_TABLE, dtype=torch.int64, device=device))
    return _TABLES[key]


def _powf(x: torch.Tensor, y: float) -> torch.Tensor:
    invc_t, logc_t, exp2_t = _powf_tables(x.device)
    A, C = _POWF_POLY, _EXP2F_POLY
    ix = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    # a subnormal x is normalised first: x 2^23, exponent less 23
    sub = (x * 2.0**23).view(torch.int32).to(torch.int64) - (23 << 23)
    ix = torch.where(ix < 0x00800000, sub, ix)
    # log2(x) = log2(z / c) + log2(c) + k, z in the subinterval of c
    tmp = (ix - _POWF_OFF) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    z = ((ix - top) & 0xFFFFFFFF).to(torch.int32).view(torch.float32).to(torch.float64)
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23
    r = fma_f64(z, invc_t[i], -1.0)
    y0 = k.to(torch.float64) + logc_t[i]
    p = fma_f64(r, A[2], A[3])
    r2 = r * r
    q = fma_f64(r2, p, fma_f64(r, A[4], y0))
    logx = fma_f64(fma_f64(r, A[0], A[1]), r2 * r2, q)
    # 2^(y log2 x) = 2^(k / 32) 2^r, |r| <= 1 / 64
    ylogx = float(np.float32(y)) * logx
    kd = ylogx + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    r = ylogx - (kd - _EXP2F_SHIFT)
    s = (exp2_t[ki & 31] + ((ki & 0x1FFFF) << 47)).view(torch.float64)
    out = fma_f64(fma_f64(r, C[0], C[1]), r * r, fma_f64(r, C[2], 1.0))
    return (out * s).to(torch.float32)


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """glibc 2.36's ``powf(x, y)`` (its ``__powf_fma``, which XLA:CPU calls
    for a float32 ``pow`` on an x86-64 machine with FMA) for a float32
    constant ``y``, with JAX's derivative of ``x ** y``. For positive
    finite ``x`` with ``|y log2 x| < 126``, every operation of the object
    code in float64 (``_powf``): log2(x) from the 16-entry table and its
    polynomial, ``y`` times it, 2^ of that from the 32-entry table and its
    polynomial, rounded once to float32; where ``vfmadd*sd`` fuses,
    ``fma_f64``. Zero, infinite, negative and NaN ``x`` take IEEE ``pow``'s
    values, as glibc's special cases do. The float64 mirror on any
    device."""
    x = x.to(torch.float32)
    regular = (x > 0) & (x < float("inf"))
    xr = torch.where(regular, x, torch.ones_like(x))
    out = _powf(xr, y)
    return torch.where(regular, out, torch.pow(x.double(), y).to(torch.float32))

