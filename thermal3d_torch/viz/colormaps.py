"""The colormaps of the entry points' figures, as matplotlib maps values.

LUTS holds, for `plasma`, `viridis`, `hot` and `gray`, the 256 RGB entries
that matplotlib 3.10.8's `colormaps[name](i, bytes=True)` gives for
i = 0..255, read once from that version and kept here as constants (the
card's machine has no matplotlib). `jet`, a segmented map in matplotlib, is
built from its segments (JET_SEGMENTS) as matplotlib builds it:
`float_table('jet')` is its float64 table, the one `colormaps['jet'](x)`
reads, and its bytes are that table times 255, truncated. `colormap` maps values as
`colormaps[name](Normalize(vmin, vmax)(x), bytes=True)` does, bit for bit:
Normalize's in-place float arithmetic in the data's own dtype, 256 bins,
x == vmax in the top bin, values below vmin the first entry, above vmax the
last, NaN (0, 0, 0, 0).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

N = 256
LUTS = {
    "plasma": (
        "0c078610078713068915068a18068b1b068c1d068d1f058e21058f2305902505912705922905932b05942d04942f0495"
        "3104963304973404983604983804993a049a3b039a3d039b3f039c40039c42039d44039e45039e47029f49029f4a02a0"
        "4c02a14e02a14f02a25101a25201a35401a35601a35701a45901a45a00a55c00a55e00a55f00a66100a66200a66400a7"
        "6500a76700a76800a76a00a76c00a86d00a86f00a87000a87200a87300a87500a87601a87801a87901a87b02a87c02a7"
        "7e03a77f03a78104a78204a78405a68506a68607a68807a58908a58b09a48c0aa48e0ca48f0da3900ea3920fa29310a1"
        "9511a19612a09713a099149f9a159e9b179e9d189d9e199c9f1a9ba01b9ba21c9aa31d99a41e98a51f97a72197a82296"
        "a92395aa2494ac2593ad2692ae2791af2890b02a8fb12b8fb22c8eb42d8db52e8cb62f8bb7308ab83289b93388ba3487"
        "bb3586bc3685bd3784be3883bf3982c03b81c13c80c23d80c33e7fc43f7ec5407dc6417cc7427bc8447ac94579ca4678"
        "cb4777cc4876cd4975ce4a75cf4b74d04d73d14e72d14f71d25070d3516fd4526ed5536dd6556dd7566cd7576bd8586a"
        "d95969da5a68db5b67dc5d66dc5e66dd5f65de6064df6163df6262e06461e16560e26660e3675fe3685ee46a5de56b5c"
        "e56c5be66d5ae76e5ae87059e87158e97257ea7356ea7455eb7654ec7754ec7853ed7952ed7b51ee7c50ef7d4fef7e4e"
        "f0804df0814df1824cf2844bf2854af38649f38748f48947f48a47f58b46f58d45f68e44f68f43f69142f79241f79341"
        "f89540f8963ff8983ef9993df99a3cfa9c3bfa9d3afa9f3afaa039fba238fba337fba436fca635fca735fca934fcaa33"
        "fcac32fcad31fdaf31fdb030fdb22ffdb32efdb52dfdb62dfdb82cfdb92bfdbb2bfdbc2afdbe29fdc029fdc128fdc328"
        "fdc427fdc626fcc726fcc926fccb25fccc25fcce25fbd024fbd124fbd324fad524fad624fad824f9d924f9db24f8dd24"
        "f8df24f7e024f7e225f6e425f6e525f5e726f5e926f4ea26f3ec26f3ee26f2f026f2f126f1f326f0f525f0f623eff821"
    ),
    "viridis": (
        "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
        "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
        "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
        "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
        "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
        "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
        "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
        "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
        "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
        "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
        "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
        "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
        "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
        "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
        "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
        "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
    ),
    "hot": (
        "0a00000d00000f00001200001500001700001a00001c00001f00002200002400002700002a00002c00002f0000310000"
        "3400003700003900003c00003f00004100004400004600004900004c00004e00005100005400005600005900005b0000"
        "5e00006100006300006600006900006b00006e00007000007300007600007800007b00007e0000800000830000850000"
        "8800008b00008d00009000009300009500009800009a00009d0000a00000a20000a50000a80000aa0000ad0000af0000"
        "b20000b50000b70000ba0000bd0000bf0000c20000c40000c70000ca0000cc0000cf0000d20000d40000d70000d90000"
        "dc0000df0000e10000e40000e70000e90000ec0000ee0000f10000f40000f60000f90000fc0000fe0000ff0200ff0500"
        "ff0700ff0a00ff0c00ff0f00ff1200ff1400ff1700ff1a00ff1c00ff1f00ff2100ff2400ff2700ff2900ff2c00ff2f00"
        "ff3100ff3400ff3600ff3900ff3c00ff3e00ff4100ff4400ff4600ff4900ff4b00ff4e00ff5100ff5300ff5600ff5900"
        "ff5b00ff5e00ff6000ff6300ff6600ff6800ff6b00ff6e00ff7000ff7300ff7500ff7800ff7b00ff7d00ff8000ff8300"
        "ff8500ff8800ff8a00ff8d00ff9000ff9200ff9500ff9700ff9a00ff9d00ff9f00ffa200ffa500ffa700ffaa00ffac00"
        "ffaf00ffb200ffb400ffb700ffba00ffbc00ffbf00ffc100ffc400ffc700ffc900ffcc00ffcf00ffd100ffd400ffd600"
        "ffd900ffdc00ffde00ffe100ffe400ffe600ffe900ffeb00ffee00fff100fff300fff600fff900fffb00fffe00ffff02"
        "ffff06ffff0affff0effff12ffff16ffff1affff1effff22ffff26ffff2affff2effff32ffff36ffff3affff3effff41"
        "ffff45ffff49ffff4dffff51ffff55ffff59ffff5dffff61ffff65ffff69ffff6dffff71ffff75ffff79ffff7dffff80"
        "ffff84ffff88ffff8cffff90ffff94ffff98ffff9cffffa0ffffa4ffffa8ffffacffffb0ffffb4ffffb8ffffbcffffbf"
        "ffffc3ffffc7ffffcbffffcfffffd3ffffd7ffffdbffffdfffffe3ffffe7ffffebffffeffffff3fffff7fffffbffffff"
    ),
    "gray": (
        "0000000101010202020303030404040505050606060707070808080909090a0a0a0b0b0b0c0c0c0d0d0d0e0e0e0f0f0f"
        "1010101111111212121313131414141515151616161717171818181919191a1a1a1b1b1b1c1c1c1d1d1d1e1e1e1f1f1f"
        "2020202020202222222323232424242424242626262727272828282828282a2a2a2b2b2b2c2c2c2c2c2c2e2e2e2f2f2f"
        "3030303030303232323333333434343434343636363737373838383838383a3a3a3b3b3b3c3c3c3c3c3c3e3e3e3f3f3f"
        "4040404141414141414343434444444545454646464747474848484949494949494b4b4b4c4c4c4d4d4d4e4e4e4f4f4f"
        "5050505151515151515353535454545555555656565757575858585959595959595b5b5b5c5c5c5d5d5d5e5e5e5f5f5f"
        "6060606161616161616363636464646565656666666767676868686969696969696b6b6b6c6c6c6d6d6d6e6e6e6f6f6f"
        "7070707171717171717373737474747575757676767777777878787979797979797b7b7b7c7c7c7d7d7d7e7e7e7f7f7f"
        "8080808181818282828383838383838585858686868787878888888989898a8a8a8b8b8b8c8c8c8d8d8d8e8e8e8f8f8f"
        "9090909191919292929393939393939595959696969797979898989999999a9a9a9b9b9b9c9c9c9d9d9d9e9e9e9f9f9f"
        "a0a0a0a1a1a1a2a2a2a3a3a3a3a3a3a5a5a5a6a6a6a7a7a7a8a8a8a9a9a9aaaaaaabababacacacadadadaeaeaeafafaf"
        "b0b0b0b1b1b1b2b2b2b3b3b3b3b3b3b5b5b5b6b6b6b7b7b7b8b8b8b9b9b9babababbbbbbbcbcbcbdbdbdbebebebfbfbf"
        "c0c0c0c1c1c1c2c2c2c3c3c3c3c3c3c5c5c5c6c6c6c7c7c7c8c8c8c9c9c9cacacacbcbcbcccccccdcdcdcecececfcfcf"
        "d0d0d0d1d1d1d2d2d2d3d3d3d3d3d3d5d5d5d6d6d6d7d7d7d8d8d8d9d9d9dadadadbdbdbdcdcdcdddddddedededfdfdf"
        "e0e0e0e1e1e1e2e2e2e3e3e3e3e3e3e5e5e5e6e6e6e7e7e7e8e8e8e9e9e9eaeaeaebebebecececedededeeeeeeefefef"
        "f0f0f0f1f1f1f2f2f2f3f3f3f3f3f3f5f5f5f6f6f6f7f7f7f8f8f8f9f9f9fafafafbfbfbfcfcfcfdfdfdfefefeffffff"
    ),
}


# matplotlib's _cm._jet_data: (x, y0, y1) rows a channel
JET_SEGMENTS = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1), (0.910, 0, 0),
              (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.00, 0, 0)),
}


def _segment_table(data) -> np.ndarray:
    """matplotlib's colors._create_lookup_table(N, data, gamma=1): N values
    of the piecewise-linear map the (x, y0, y1) rows define."""
    adata = np.array(data)
    x, y0, y1 = adata[:, 0] * (N - 1), adata[:, 1], adata[:, 2]
    xind = (N - 1) * np.linspace(0, 1, N) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def float_table(name: str) -> np.ndarray:
    """float64 [N, 3]: the RGB entries of a segmented map ('jet') as
    matplotlib's table holds them."""
    if name != "jet":
        raise ValueError(f"no float table for {name!r}: only the segmented 'jet'")
    table = np.stack([_segment_table(JET_SEGMENTS[c]) for c in ("red", "green", "blue")], -1)
    table.flags.writeable = False
    return table


@functools.lru_cache(maxsize=None)
def rgba_table(name: str) -> np.ndarray:
    """uint8 [N + 3, 4]: the N entries, then under, over and bad (NaN), as
    matplotlib orders them."""
    if name == "jet":
        rgb = (float_table(name) * 255).astype(np.uint8)
    else:
        rgb = np.frombuffer(bytes.fromhex("".join(LUTS[name])), np.uint8).reshape(N, 3)
    table = np.zeros((N + 3, 4), np.uint8)
    table[:N, :3] = rgb
    table[:N, 3] = 255
    table[N], table[N + 1] = table[0], table[N - 1]
    table.flags.writeable = False
    return table


def _limit(v) -> np.generic:
    """A limit as Normalize.process_value makes it: a float keeps its numpy
    float type (a Python float is float64); an integer becomes float64."""
    a = np.asarray([v])
    if a.dtype.kind != "f":
        a = a.astype(np.promote_types(a.dtype, np.float32))
    return a[0]


def normalize(x, vmin, vmax) -> np.ndarray:
    """Normalize(vmin, vmax)(x): (x − vmin) / (vmax − vmin) in place in x's
    float type (integers go to float32 or wider), all zeros when
    vmin == vmax; no clipping."""
    x = np.asarray(x)
    dtype = x.dtype if x.dtype.kind == "f" else np.promote_types(x.dtype, np.float32)
    data = np.array(x, dtype=dtype, copy=True)
    vmin, vmax = _limit(vmin), _limit(vmax)
    if vmin == vmax:
        data.fill(0)
        return data
    if vmin > vmax:
        raise ValueError("minvalue must be less than or equal to maxvalue")
    data -= vmin
    data /= (vmax - vmin)
    return data


def autoscale(*arrays):
    """The limits matplotlib's imshow takes from the data: the least and the
    largest value that is not NaN, in the data's own type."""
    return (min(np.nanmin(np.asarray(a)) for a in arrays),
            max(np.nanmax(np.asarray(a)) for a in arrays))


def colormap(x, name: str, vmin=None, vmax=None) -> np.ndarray:
    """uint8 RGBA [..., 4] of `x` through colormap `name`; a missing limit is
    autoscaled from x."""
    if vmin is None or vmax is None:
        lo, hi = autoscale(x)
        vmin = lo if vmin is None else vmin
        vmax = hi if vmax is None else vmax
    return rgba_table(name).take(_table_index(normalize(x, vmin, vmax)), axis=0, mode="clip")


def _table_index(xa: np.ndarray) -> np.ndarray:
    """Colormap.__call__'s index of each value of the float array xa
    (changed in place): 256 bins of [0, 1], 1.0 in the top bin, then
    N, N + 1, N + 2 for under, over and NaN."""
    xa *= N
    xa[xa == N] = N - 1
    under, over, bad = xa < 0, xa >= N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over], idx[bad] = N, N + 1, N + 2
    return idx


def colormap_float(x, name: str) -> np.ndarray:
    """float64 RGB [..., 3] of `colormaps[name](x)[..., :3]` for float x
    already in [0, 1] (a segmented map: 'jet'): below 0 the first entry,
    above 1 the last, NaN 0."""
    table = float_table(name)
    table = np.concatenate([table, table[:1], table[-1:], np.zeros((1, 3))])
    return table.take(_table_index(np.array(x, copy=True)), axis=0, mode="clip")


def colormap_rgb(x, name: str, vmin=None, vmax=None,
                 background: Optional[int] = 255) -> np.ndarray:
    """colormap() on a figure's background: uint8 RGB [..., 3], where
    transparent (NaN) pixels take the background grey level."""
    rgba = colormap(x, name, vmin, vmax)
    rgb = rgba[..., :3].copy()
    rgb[rgba[..., 3] == 0] = background
    return rgb
