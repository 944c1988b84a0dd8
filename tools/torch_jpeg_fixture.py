"""Write ``tests/data/room_1296x840_q90.jpg``: frame 0 of the port's room
dataset at 1296x840, encoded by PIL as baseline JPEG (quality 90, 4:2:0,
libjpeg's defaults), the file ``chip_smoke.py`` times the host core's JPEG
decode on (the GPU machine has no encoder) and
``tests/test_torch_codec.py`` holds to PIL's decode.

    python3 tools/torch_jpeg_fixture.py       (needs PIL)
"""

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "tests" / "data" / "room_1296x840_q90.jpg"


def main() -> int:
    from PIL import Image

    from qed_splatter_tpu_torch import testing
    from qed_splatter_tpu_torch.data.png import read_png

    with tempfile.TemporaryDirectory() as tmp:
        testing.write_room_dataset(tmp, num_frames=1, width=1296, height=840)
        img = read_png(Path(tmp) / "images" / "frame_0000.png")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(OUT, "JPEG", quality=90, subsampling=2)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
