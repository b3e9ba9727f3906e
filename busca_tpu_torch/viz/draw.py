"""Debug visualization: track boxes and association montages (a copy of
``busca_tpu.viz.draw``: numpy and cv2 host code).

Behavioral equivalent of busca/visualization.py: per-id colored boxes in
solid (active) / dashed (inactive) / dotted styles (:5-31, :104-147), and the
BUSCA decision montage — each track's memory row next to its candidate crops
annotated with predicted probabilities (``create_batch_image``, :33-96) — the
tool for eyeballing *why* the decision Transformer picked a candidate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# Deterministic per-id palette (80 distinct hues like the reference :243).
_PALETTE = None


def _palette() -> np.ndarray:
    global _PALETTE
    if _PALETTE is None:
        rng = np.random.RandomState(37)
        hues = np.linspace(0, 179, 80, dtype=np.uint8)
        rng.shuffle(hues)
        hsv = np.stack(
            [hues, np.full(80, 200, np.uint8), np.full(80, 255, np.uint8)],
            axis=1,
        )[None]
        if cv2 is not None:
            _PALETTE = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[0]
        else:
            _PALETTE = np.stack([hues * 1, 255 - hues, hues // 2], 1)
    return _PALETTE


def id_color(target_id: int) -> tuple:
    c = _palette()[int(target_id) % 80]
    return int(c[0]), int(c[1]), int(c[2])


def _segmented_line(img, p1, p2, color, thickness, on, off):
    """Draw a dashed/dotted line as alternating segments."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    length = np.linalg.norm(p2 - p1)
    if length < 1:
        return
    direction = (p2 - p1) / length
    pos = 0.0
    while pos < length:
        a = p1 + direction * pos
        b = p1 + direction * min(pos + on, length)
        cv2.line(img, tuple(a.astype(int)), tuple(b.astype(int)), color,
                 thickness)
        pos += on + off


def plot_box(
    frame_image: np.ndarray,
    target_id: int,
    target_bbox: Sequence[float],
    style: str = "solid",
    thickness: int = 2,
    display_id: bool = False,
    id_size: float = 1.0,
    color: Optional[tuple] = None,
) -> np.ndarray:
    """Draw one track box (in place) with a per-id color.

    Args:
      target_bbox: ltrb in image coordinates.
      style: 'solid' | 'dashed' | 'dotted'.
    """
    if cv2 is None:
        return frame_image
    color = color or id_color(target_id)
    x1, y1, x2, y2 = [int(v) for v in target_bbox]
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if style == "solid":
        cv2.rectangle(frame_image, (x1, y1), (x2, y2), color, thickness)
    else:
        on, off = (9, 6) if style == "dashed" else (2, 5)
        for a, b in zip(corners, corners[1:] + corners[:1]):
            _segmented_line(frame_image, a, b, color, thickness, on, off)
    if display_id:
        cv2.putText(
            frame_image,
            str(target_id),
            (x1, max(y1 - 4, 10)),
            cv2.FONT_HERSHEY_SIMPLEX,
            0.6 * id_size,
            color,
            max(1, thickness - 1),
        )
    return frame_image


def create_batch_image(
    image_list_mem: np.ndarray,
    image_list_can: np.ndarray,
    output_probs: Optional[np.ndarray] = None,
    max_batch_size: int = 5,
    pad: int = 2,
) -> np.ndarray:
    """Montage of memory + candidate crops with predicted probabilities.

    Args:
      image_list_mem: ``[B, L, H, W, 3]`` uint8 BGR memory crops.
      image_list_can: ``[B, C, H, W, 3]`` uint8 BGR candidate crops.
      output_probs: ``[B, C+extras]`` softmax outputs; the first C values
        annotate the candidate crops, the rest (NON/BAD) print on the divider.
    Returns:
      one uint8 BGR image: a row per track — memory crops, a divider, then
      candidate crops labeled with their probability.
    """
    mem = np.asarray(image_list_mem)
    can = np.asarray(image_list_can)
    b = min(mem.shape[0], max_batch_size)
    h, w = mem.shape[2], mem.shape[3]
    div_w = w // 2 + pad
    n_cols = mem.shape[1] + can.shape[1]
    row_w = n_cols * (w + pad) + div_w
    canvas = np.full((b * (h + pad), row_w, 3), 255, dtype=np.uint8)

    for i in range(b):
        y = i * (h + pad)
        x = 0
        for m in range(mem.shape[1]):
            canvas[y:y + h, x:x + w] = mem[i, m].astype(np.uint8)
            x += w + pad
        # divider with NON/BAD probabilities
        if output_probs is not None and cv2 is not None:
            extras = output_probs[i][can.shape[1]:]
            for k, p in enumerate(extras):
                cv2.putText(
                    canvas,
                    f"{p:.2f}",
                    (x, y + 20 + 22 * k),
                    cv2.FONT_HERSHEY_SIMPLEX,
                    0.45,
                    (0, 0, 255),
                    1,
                )
        x += div_w
        for c in range(can.shape[1]):
            canvas[y:y + h, x:x + w] = can[i, c].astype(np.uint8)
            if output_probs is not None and cv2 is not None:
                p = float(output_probs[i][c])
                color = (0, 200, 0) if p > 0.5 else (0, 0, 255)
                cv2.putText(
                    canvas,
                    f"{p:.2f}",
                    (x + 2, y + 18),
                    cv2.FONT_HERSHEY_SIMPLEX,
                    0.5,
                    color,
                    1,
                )
            x += w + pad
    return canvas
