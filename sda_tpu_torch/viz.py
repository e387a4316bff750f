r"""Host-side rendering of vorticity and potential-vorticity fields.

Counterpart of :mod:`sda_tpu.viz`: the signed-power icefire colouring of a
field, grid montages with observation-mask overlays, diagonal "sandwich"
stacks and animated GIFs. It uses numpy and the standard library only:
seaborn's icefire table is copied below, the colour lookup is matplotlib's
``Colormap.__call__`` for float input, and the PNG and GIF files are
written by hand (``zlib``, ``struct``, LZW), so nothing here needs PIL,
seaborn or matplotlib.

Every pixel of a rendered field is one of the table's 256 colours, so a
GIF with the table as its palette holds the frames exactly.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

# seaborn's ``_icefire_lut`` (seaborn 0.13.2, ``seaborn/cm.py``, BSD-3-Clause
# licence, Copyright (c) 2012-2023 Michael L. Waskom), the 256 RGB entries of
# ``seaborn.cm.icefire`` in order.
ICEFIRE = np.array([
    (0.73936227, 0.90443867, 0.85757238), (0.72888063, 0.89639109, 0.85488394), (0.71834255, 0.88842162, 0.8521605),
    (0.70773866, 0.88052939, 0.849422), (0.69706215, 0.87271313, 0.84668315), (0.68629021, 0.86497329, 0.84398721),
    (0.67543654, 0.85730617, 0.84130969), (0.66448539, 0.84971123, 0.83868005), (0.65342679, 0.84218728, 0.83611512),
    (0.64231804, 0.83471867, 0.83358584), (0.63117745, 0.827294, 0.83113431), (0.62000484, 0.81991069, 0.82876741),
    (0.60879435, 0.81256797, 0.82648905), (0.59754118, 0.80526458, 0.82430414), (0.58624247, 0.79799884, 0.82221573),
    (0.57489525, 0.7907688, 0.82022901), (0.56349779, 0.78357215, 0.81834861), (0.55204294, 0.77640827, 0.81657563),
    (0.54052516, 0.76927562, 0.81491462), (0.52894085, 0.76217215, 0.81336913), (0.51728854, 0.75509528, 0.81194156),
    (0.50555676, 0.74804469, 0.81063503), (0.49373871, 0.7410187, 0.80945242), (0.48183174, 0.73401449, 0.80839675),
    (0.46982587, 0.72703075, 0.80747097), (0.45770893, 0.72006648, 0.80667756), (0.44547249, 0.71311941, 0.80601991),
    (0.43318643, 0.70617126, 0.80549278), (0.42110294, 0.69916972, 0.80506683), (0.40925101, 0.69211059, 0.80473246),
    (0.3976693, 0.68498786, 0.80448272), (0.38632002, 0.67781125, 0.80431024), (0.37523981, 0.67057537, 0.80420832),
    (0.36442578, 0.66328229, 0.80417474), (0.35385939, 0.65593699, 0.80420591), (0.34358916, 0.64853177, 0.8043),
    (0.33355526, 0.64107876, 0.80445484), (0.32383062, 0.63356578, 0.80467091), (0.31434372, 0.62600624, 0.8049475),
    (0.30516161, 0.618389, 0.80528692), (0.29623491, 0.61072284, 0.80569021), (0.28759072, 0.60300319, 0.80616055),
    (0.27923924, 0.59522877, 0.80669803), (0.27114651, 0.5874047, 0.80730545), (0.26337153, 0.57952055, 0.80799113),
    (0.25588696, 0.57157984, 0.80875922), (0.248686, 0.56358255, 0.80961366), (0.24180668, 0.55552289, 0.81055123),
    (0.23526251, 0.54739477, 0.8115939), (0.22921445, 0.53918506, 0.81267292), (0.22397687, 0.53086094, 0.8137141),
    (0.21977058, 0.52241482, 0.81457651), (0.21658989, 0.51384321, 0.81528511), (0.21452772, 0.50514155, 0.81577278),
    (0.21372783, 0.49630865, 0.81589566), (0.21409503, 0.48734861, 0.81566163), (0.2157176, 0.47827123, 0.81487615),
    (0.21842857, 0.46909168, 0.81351614), (0.22211705, 0.45983212, 0.81146983), (0.22665681, 0.45052233, 0.80860217),
    (0.23176013, 0.44119137, 0.80494325), (0.23727775, 0.43187704, 0.80038017), (0.24298285, 0.42261123, 0.79493267),
    (0.24865068, 0.41341842, 0.78869164), (0.25423116, 0.40433127, 0.78155831), (0.25950239, 0.39535521, 0.77376848),
    (0.2644736, 0.38651212, 0.76524809), (0.26901584, 0.37779582, 0.75621942), (0.27318141, 0.36922056, 0.746605),
    (0.27690355, 0.3607736, 0.73659374), (0.28023585, 0.35244234, 0.72622103), (0.28306009, 0.34438449, 0.71500731),
    (0.28535896, 0.33660243, 0.70303975), (0.28708711, 0.32912157, 0.69034504), (0.28816354, 0.32200604, 0.67684067),
    (0.28862749, 0.31519824, 0.66278813), (0.28847904, 0.30869064, 0.6482815), (0.28770912, 0.30250126, 0.63331265),
    (0.28640325, 0.29655509, 0.61811374), (0.28458943, 0.29082155, 0.60280913), (0.28233561, 0.28527482, 0.58742866),
    (0.27967038, 0.2798938, 0.57204225), (0.27665361, 0.27465357, 0.55667809), (0.27332564, 0.2695165, 0.54145387),
    (0.26973851, 0.26447054, 0.52634916), (0.2659204, 0.25949691, 0.511417), (0.26190145, 0.25458123, 0.49668768),
    (0.2577151, 0.24971691, 0.48214874), (0.25337618, 0.24490494, 0.46778758), (0.24890842, 0.24013332, 0.45363816),
    (0.24433654, 0.23539226, 0.4397245), (0.23967922, 0.23067729, 0.4260591), (0.23495608, 0.22598894, 0.41262952),
    (0.23018113, 0.22132414, 0.39945577), (0.22534609, 0.21670847, 0.38645794), (0.22048761, 0.21211723, 0.37372555),
    (0.2156198, 0.20755389, 0.36125301), (0.21074637, 0.20302717, 0.34903192), (0.20586893, 0.19855368, 0.33701661),
    (0.20101757, 0.19411573, 0.32529173), (0.19619947, 0.18972425, 0.31383846), (0.19140726, 0.18540157, 0.30260777),
    (0.1866769, 0.1811332, 0.29166583), (0.18201285, 0.17694992, 0.28088776), (0.17745228, 0.17282141, 0.27044211),
    (0.17300684, 0.16876921, 0.26024893), (0.16868273, 0.16479861, 0.25034479), (0.16448691, 0.16091728, 0.24075373),
    (0.16043195, 0.15714351, 0.23141745), (0.15652427, 0.15348248, 0.22238175), (0.15277065, 0.14994111, 0.21368395),
    (0.14918274, 0.14653431, 0.20529486), (0.14577095, 0.14327403, 0.19720829), (0.14254381, 0.14016944, 0.18944326),
    (0.13951035, 0.13723063, 0.18201072), (0.13667798, 0.13446606, 0.17493774), (0.13405762, 0.13188822, 0.16820842),
    (0.13165767, 0.12950667, 0.16183275), (0.12948748, 0.12733187, 0.15580631), (0.12755435, 0.1253723, 0.15014098),
    (0.12586516, 0.12363617, 0.1448459), (0.12442647, 0.12213143, 0.13992571), (0.12324241, 0.12086419, 0.13539995),
    (0.12232067, 0.11984278, 0.13124644), (0.12166209, 0.11907077, 0.12749671), (0.12126982, 0.11855309, 0.12415079),
    (0.12114244, 0.11829179, 0.1212385), (0.12127766, 0.11828837, 0.11878534), (0.12284806, 0.1179729, 0.11772022),
    (0.12619498, 0.11721796, 0.11770203), (0.129968, 0.11663788, 0.11792377), (0.13410011, 0.11625146, 0.11839138),
    (0.13855459, 0.11606618, 0.11910584), (0.14333775, 0.11607038, 0.1200606), (0.148417, 0.11626929, 0.12125453),
    (0.15377389, 0.11666192, 0.12268364), (0.15941427, 0.11723486, 0.12433911), (0.16533376, 0.11797856, 0.12621303),
    (0.17152547, 0.11888403, 0.12829735), (0.17797765, 0.11994436, 0.13058435), (0.18468769, 0.12114722, 0.13306426),
    (0.19165663, 0.12247737, 0.13572616), (0.19884415, 0.12394381, 0.1385669), (0.20627181, 0.12551883, 0.14157124),
    (0.21394877, 0.12718055, 0.14472604), (0.22184572, 0.12893119, 0.14802579), (0.22994394, 0.13076731, 0.15146314),
    (0.23823937, 0.13267611, 0.15502793), (0.24676041, 0.13462172, 0.15870321), (0.25546457, 0.13661751, 0.16248722),
    (0.26433628, 0.13865956, 0.16637301), (0.27341345, 0.14070412, 0.17034221), (0.28264773, 0.14277192, 0.1743957),
    (0.29202272, 0.14486161, 0.17852793), (0.30159648, 0.14691224, 0.1827169), (0.31129002, 0.14897583, 0.18695213),
    (0.32111555, 0.15103351, 0.19119629), (0.33107961, 0.1530674, 0.19543758), (0.34119892, 0.15504762, 0.1996803),
    (0.35142388, 0.15701131, 0.20389086), (0.36178937, 0.1589124, 0.20807639), (0.37229381, 0.16073993, 0.21223189),
    (0.38288348, 0.16254006, 0.2163249), (0.39359592, 0.16426336, 0.22036577), (0.40444332, 0.16588767, 0.22434027),
    (0.41537995, 0.16745325, 0.2282297), (0.42640867, 0.16894939, 0.23202755), (0.43754706, 0.17034847, 0.23572899),
    (0.44878564, 0.1716535, 0.23932344), (0.4601126, 0.17287365, 0.24278607), (0.47151732, 0.17401641, 0.24610337),
    (0.48300689, 0.17506676, 0.2492737), (0.49458302, 0.17601892, 0.25227688), (0.50623876, 0.17687777, 0.255096),
    (0.5179623, 0.17765528, 0.2577162), (0.52975234, 0.17835232, 0.2601134), (0.54159776, 0.17898292, 0.26226847),
    (0.55348804, 0.17956232, 0.26416003), (0.56541729, 0.18010175, 0.26575971), (0.57736669, 0.180631, 0.26704888),
    (0.58932081, 0.18117827, 0.26800409), (0.60127582, 0.18175888, 0.26858488), (0.61319563, 0.1824336, 0.2687872),
    (0.62506376, 0.18324015, 0.26858301), (0.63681202, 0.18430173, 0.26795276), (0.64842603, 0.18565472, 0.26689463),
    (0.65988195, 0.18734638, 0.26543435), (0.67111966, 0.18948885, 0.26357955), (0.68209194, 0.19216636, 0.26137175),
    (0.69281185, 0.19535326, 0.25887063), (0.70335022, 0.19891271, 0.25617971), (0.71375229, 0.20276438, 0.25331365),
    (0.72401436, 0.20691287, 0.25027366), (0.73407638, 0.21145051, 0.24710661), (0.74396983, 0.21631913, 0.24380715),
    (0.75361506, 0.22163653, 0.24043996), (0.7630579, 0.22731637, 0.23700095), (0.77222228, 0.23346231, 0.23356628),
    (0.78115441, 0.23998404, 0.23013825), (0.78979746, 0.24694858, 0.22678822), (0.79819286, 0.25427223, 0.22352658),
    (0.80630444, 0.26198807, 0.22040877), (0.81417437, 0.27001406, 0.21744645), (0.82177364, 0.27837336, 0.21468316),
    (0.82915955, 0.28696963, 0.21210766), (0.83628628, 0.2958499, 0.20977813), (0.84322168, 0.30491136, 0.20766435),
    (0.84995458, 0.31415945, 0.2057863), (0.85648867, 0.32358058, 0.20415327), (0.86286243, 0.33312058, 0.20274969),
    (0.86908321, 0.34276705, 0.20157271), (0.87512876, 0.3525416, 0.20064949), (0.88100349, 0.36243385, 0.19999078),
    (0.8866469, 0.37249496, 0.1997976), (0.89203964, 0.38273475, 0.20013431), (0.89713496, 0.39318156, 0.20121514),
    (0.90195099, 0.40380687, 0.20301555), (0.90648379, 0.41460191, 0.20558847), (0.9106967, 0.42557857, 0.20918529),
    (0.91463791, 0.43668557, 0.21367954), (0.91830723, 0.44790913, 0.21916352), (0.92171507, 0.45922856, 0.22568002),
    (0.92491786, 0.4705936, 0.23308207), (0.92790792, 0.48200153, 0.24145932), (0.93073701, 0.49341219, 0.25065486),
    (0.93343918, 0.5048017, 0.26056148), (0.93602064, 0.51616486, 0.27118485), (0.93850535, 0.52748892, 0.28242464),
    (0.94092933, 0.53875462, 0.29416042), (0.94330011, 0.5499628, 0.30634189), (0.94563159, 0.56110987, 0.31891624),
    (0.94792955, 0.57219822, 0.33184256), (0.95020929, 0.5832232, 0.34508419), (0.95247324, 0.59419035, 0.35859866),
    (0.95471709, 0.60510869, 0.37236035), (0.95698411, 0.61595766, 0.38629631), (0.95923863, 0.62676473, 0.40043317),
    (0.9615041, 0.6375203, 0.41474106), (0.96371553, 0.64826619, 0.42928335), (0.96591497, 0.65899621, 0.44380444),
    (0.96809871, 0.66971662, 0.45830232), (0.9702495, 0.6804394, 0.47280492), (0.9723881, 0.69115622, 0.48729272),
    (0.97450723, 0.70187358, 0.50178034), (0.9766108, 0.712592, 0.51626837), (0.97871716, 0.72330511, 0.53074053),
    (0.98082222, 0.73401769, 0.54520694), (0.9829001, 0.74474445, 0.5597019), (0.98497466, 0.75547635, 0.57420239),
    (0.98705581, 0.76621129, 0.58870185), (0.98913325, 0.77695637, 0.60321626), (0.99119918, 0.78771716, 0.61775821),
    (0.9932672, 0.79848979, 0.63231691), (0.99535958, 0.80926704, 0.64687278), (0.99740544, 0.82008078, 0.66150571),
    (0.9992197, 0.83100723, 0.6764127),
], dtype=np.float64)

N = len(ICEFIRE)

# The 8-bit colours the JAX function gives, ``uint8(256 * lut)``, with
# matplotlib's "bad" colour (0, 0, 0) for NaN as entry N. The table's largest
# entry is 0.99922, so ``256 * lut`` stays below 256 and never wraps.
PALETTE = np.concatenate([256 * ICEFIRE, np.zeros((1, 3))]).astype(np.uint8)


def icefire_index(w, vmin: float = -1.25, vmax: float = 1.25) -> np.ndarray:
    r"""The icefire table entry of each value of ``w``: the signed-power
    transform of :func:`vorticity2rgb` in ``w``'s own dtype, then
    matplotlib's float lookup (scale by N, N itself maps to N - 1, values
    below 0 take entry 0, values from N on take entry N - 1, NaN takes
    entry N, the rest truncate)."""

    w = np.asarray(w)
    w = (w - vmin) / (vmax - vmin)
    w = 2 * w - 1
    w = np.sign(w) * np.abs(w) ** 0.8
    w = (w + 1) / 2

    x = np.array(w, copy=True)
    x *= N
    x[x == N] = N - 1
    under, over, bad = x < 0, x >= N, np.isnan(x)
    with np.errstate(invalid='ignore'):
        index = x.astype(int)
    index[under] = 0
    index[over] = N - 1
    index[bad] = N

    return index


def vorticity2rgb(w, vmin: float = -1.25, vmax: float = 1.25) -> np.ndarray:
    r"""Signed-power icefire colormap of a vorticity field: ``(..., 3)``
    uint8."""

    return PALETTE[icefire_index(w, vmin, vmax)]


class RGBImage:
    r"""An 8-bit RGB image: ``np.asarray(image)`` is its ``(H, W, 3)``
    canvas, ``size`` is ``(width, height)`` and :meth:`save` writes a PNG."""

    def __init__(self, canvas: np.ndarray):
        self.canvas = np.ascontiguousarray(canvas, dtype=np.uint8)

    @property
    def size(self):
        height, width, _ = self.canvas.shape
        return width, height

    def __array__(self, dtype=None, copy=None):
        return self.canvas if dtype is None else self.canvas.astype(dtype)

    def save(self, file: Union[str, Path]) -> None:
        r"""Writes the canvas as a PNG: 8-bit RGB, no interlace, filter 0
        (none) on every row, one zlib stream in one IDAT chunk."""

        height, width, _ = self.canvas.shape
        rows = np.concatenate([np.zeros((height, 1), np.uint8), self.canvas.reshape(height, 3 * width)], axis=1)

        def chunk(kind: bytes, data: bytes) -> bytes:
            return struct.pack('>I', len(data)) + kind + data + struct.pack('>I', zlib.crc32(kind + data))

        header = struct.pack('>IIBBBBB', width, height, 8, 2, 0, 0, 0)
        with open(file, 'wb') as f:
            f.write(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', header) + chunk(b'IDAT', zlib.compress(rows.tobytes()))
                    + chunk(b'IEND', b''))


def draw(w, mask=None, pad: int = 4, zoom: int = 1, **kwargs) -> RGBImage:
    r"""Grid montage of vorticity fields ``(rows, cols, H, W)`` (fewer
    leading axes fill in from the left) with an optional observation-mask
    overlay: unobserved pixels are greyed out."""

    w = vorticity2rgb(w, **kwargs)
    w = w[(None,) * (5 - w.ndim)]
    rows, cols, h, width, _ = w.shape

    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        mask = np.broadcast_to(mask, (rows, cols, h, width))
        w = np.where(mask[..., None], w, np.uint8(240))

    canvas = np.full((rows * (h + pad) + pad, cols * (width + pad) + pad, 3), 255, dtype=np.uint8)

    for i in range(rows):
        for j in range(cols):
            top = i * (h + pad) + pad
            left = j * (width + pad) + pad
            canvas[top: top + h, left: left + width] = w[i, j]

    if zoom > 1:
        canvas = np.repeat(np.repeat(canvas, zoom, axis=0), zoom, axis=1)

    return RGBImage(canvas)


def sandwich(w, offset: int = 5, border: int = 1, mirror: bool = False, zoom: int = 1, **kwargs) -> RGBImage:
    r"""Diagonally stacked rendering of a trajectory ``(n, H, W)``, later
    frames in front with a white border."""

    w = vorticity2rgb(w, **kwargs)
    if zoom > 1:
        w = w.repeat(zoom, axis=1).repeat(zoom, axis=2)
        offset, border = zoom * offset, zoom * border
    n, h, width, _ = w.shape

    if mirror:
        w = w[:, :, ::-1]

    canvas = np.full((h + (n - 1) * offset, width + (n - 1) * offset, 3), 255, dtype=np.uint8)

    for i in range(n):
        top, left = i * offset, i * offset
        canvas[max(top - border, 0):, max(left - border, 0):] = 255
        canvas[top: top + h, left: left + width] = w[i]

    if mirror:
        canvas = canvas[:, ::-1]

    return RGBImage(canvas)


def lzw(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    r"""GIF's variable-length LZW code of a stream of palette indices: a
    clear code first and whenever the 4,096-entry table fills, then the end
    code, packed least significant bit first."""

    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    bits = count = 0

    def emit(code, size):
        nonlocal bits, count
        bits |= code << count
        count += size
        while count >= 8:
            out.append(bits & 0xFF)
            bits >>= 8
            count -= 8

    size, table, free = min_code_size + 1, {}, end + 1
    emit(clear, size)
    pixels = indices.tolist()
    prefix = pixels[0]
    for p in pixels[1:]:
        key = (prefix << 8) | p
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        table[key] = free
        free += 1
        if free == 4096:
            emit(clear, size)
            size, table, free = min_code_size + 1, {}, end + 1
        elif free > 1 << size:
            size += 1
        prefix = p
    emit(prefix, size)
    if free + 1 > 1 << size and size < 12:  # the decoder counts an entry for the last code too
        size += 1
    emit(end, size)
    if count:
        out.append(bits & 0xFF)

    return bytes(out)


def save_gif(w, file: Union[str, Path], dt: float = 0.2, zoom: int = 1, **kwargs) -> None:
    r"""Animated GIF89a of a vorticity trajectory ``(frames, H, W)``: the
    icefire table as the global palette, each frame's table entries as its
    pixels (so the frames are exactly :func:`vorticity2rgb`'s), looping
    forever, ``int(1000 * dt) // 10`` centiseconds per frame."""

    index = icefire_index(w, **kwargs)
    if (index == N).any():
        raise ValueError('a GIF frame must hold no NaN: the palette has no colour for it')
    if zoom > 1:
        index = index.repeat(zoom, axis=1).repeat(zoom, axis=2)
    frames, height, width = index.shape
    delay = int(1000 * dt) // 10

    data = bytearray(b'GIF89a')
    # Logical screen: a global table of 2^(7 + 1) colours, 8 bits each.
    data += struct.pack('<HHBBB', width, height, 0xF7, 0, 0)
    data += PALETTE[:N].tobytes()
    data += b'\x21\xff\x0bNETSCAPE2.0\x03\x01' + struct.pack('<H', 0) + b'\x00'  # loop forever
    for frame in index.astype(np.uint8):
        data += b'\x21\xf9\x04\x00' + struct.pack('<H', delay) + b'\x00\x00'  # graphic control
        data += b'\x2c' + struct.pack('<HHHHB', 0, 0, width, height, 0)  # image descriptor
        code = lzw(frame.ravel())
        data += b'\x08'
        for k in range(0, len(code), 255):
            block = code[k: k + 255]
            data += bytes([len(block)]) + block
        data += b'\x00'
    data += b'\x3b'

    with open(file, 'wb') as f:
        f.write(bytes(data))
