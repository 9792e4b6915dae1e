"""Write ``orienmask_tpu_torch/utils/label_font.npz``: the glyph atlas the
port's ``InferenceVisualizer`` draws its labels with.

The JAX visualizer labels boxes with ``cv2.putText(..., FONT_HERSHEY_DUPLEX,
0.4, (255, 255, 255), 1, LINE_AA)`` and sizes the label's background with
``cv2.getTextSize``.  OpenCV 5 renders that font with whole-pixel advances:
a string is its characters' coverage bitmaps, each at the pen position (the
sum of the advances before it), blended in order over the image as
``(dst * (255 - a) + 255 * a + 127) // 255``, clipped at the image's edges;
its width is the sum of the advances plus 1 and its height 11.  This script
renders each printable ASCII character alone on black (the pixel values are
then its coverage) and records its advance, writes the atlas, and checks the
rule against cv2 on every COCO and VOC label at several scores and on 400
random strings, on black and on coloured backgrounds.

Run from the repository root on a machine with cv2 (the card's machine has
none, which is why the atlas is committed): ``python3 probe/make_glyph_atlas.py``.
"""

import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from orienmask_tpu_torch.data.dataset import COCODataset, VOCDataset  # noqa: E402

FONT, SCALE, THICKNESS = cv2.FONT_HERSHEY_DUPLEX, 0.4, 1
OUT = ROOT / "orienmask_tpu_torch" / "utils" / "label_font.npz"
CHARS = [chr(i) for i in range(32, 127)]
ORG = (16, 24)


def render(text, background, size=(48, 320)):
    image = np.full(size + (3,), background, np.uint8)
    cv2.putText(image, text, ORG, FONT, SCALE, (255, 255, 255), THICKNESS, cv2.LINE_AA)
    return image


def build():
    advance, top, left, shapes, alphas = [], [], [], [], []
    for c in CHARS:
        width, height = cv2.getTextSize(c, FONT, SCALE, THICKNESS)[0]
        assert height == 11, (c, height)
        advance.append(width - 1)
        a = render(c, 0)
        assert (a[..., 0] == a[..., 1]).all() and (a[..., 0] == a[..., 2]).all()
        ys, xs = np.nonzero(a[..., 0])
        if len(ys) == 0:  # the space
            top.append(0), left.append(0), shapes.append((0, 0))
            continue
        y0, x0 = ys.min(), xs.min()
        assert y0 > 0 and x0 > 0, c  # the canvas holds the whole glyph
        crop = a[y0:ys.max() + 1, x0:xs.max() + 1, 0]
        top.append(y0 - ORG[1]), left.append(x0 - ORG[0]), shapes.append(crop.shape)
        alphas.append(crop.reshape(-1))
    return dict(chars="".join(CHARS), advance=np.array(advance, np.int16),
                top=np.array(top, np.int16), left=np.array(left, np.int16),
                shape=np.array(shapes, np.int16), alpha=np.concatenate(alphas),
                height=np.int16(11))


def compose(atlas, text, background, size=(48, 320)):
    """The rule above, in numpy: what the port's visualizer does."""
    image = np.full(size, background, np.int64)
    offsets = np.cumsum([0] + [int(np.prod(s)) for s in atlas["shape"]])
    x = ORG[0]
    for c in text:
        i = atlas["chars"].index(c)
        h, w = atlas["shape"][i]
        if h:
            a = atlas["alpha"][offsets[i]:offsets[i] + h * w].reshape(h, w).astype(np.int64)
            y0, x0 = ORG[1] + atlas["top"][i], x + atlas["left"][i]
            dst = image[y0:y0 + h, x0:x0 + w]
            image[y0:y0 + h, x0:x0 + w] = (dst * (255 - a) + 255 * a + 127) // 255
        x += atlas["advance"][i]
    return image


def check(atlas):
    rng = np.random.default_rng(0)
    labels = ["%s %.2f" % (n, s) for n in COCODataset.CLASSES + VOCDataset.CLASSES
              for s in (0.3, 0.57, 0.99, 1.0)]
    labels += ["".join(rng.choice(CHARS, rng.integers(1, 16))) for _ in range(400)]
    for text in labels:
        width, height = cv2.getTextSize(text, FONT, SCALE, THICKNESS)[0]
        want_width = sum(int(atlas["advance"][atlas["chars"].index(c)]) for c in text) + 1
        assert (width, height) == (want_width, 11), (text, width, height)
        for background in (0, 37, 200):
            want = render(text, background)[..., 0]
            assert np.array_equal(compose(atlas, text, background), want), (text, background)
    return len(labels)


if __name__ == "__main__":
    atlas = build()
    n = check(atlas)
    np.savez_compressed(OUT, **atlas)
    print(f"{OUT.relative_to(ROOT)}: {len(CHARS)} glyphs, {atlas['alpha'].size} coverage bytes, "
          f"{OUT.stat().st_size} bytes; the rule holds on {n} strings x 3 backgrounds "
          f"(cv2 {cv2.__version__})")
