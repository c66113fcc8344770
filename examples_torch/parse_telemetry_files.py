"""File-based telemetry parsing: CCSDS with sync-pattern resync and
VITA49 with a per-frame callback (reference:
examples/parse_ccsds_file_sync.zig + parse_vita49_callback.zig; the
PyTorch port of examples/parse_telemetry_files.py). Host code only:
``device`` is not used.

Run: ``python examples_torch/parse_telemetry_files.py`` (writes its
files into a temporary directory).
"""

import os
import tempfile

from astroz_tpu_torch.io import Ccsds, Parser, Vita49
from astroz_tpu_torch.io.ccsds import build_packet as ccsds_packet
from astroz_tpu_torch.io.vita49 import build_packet as vita49_packet

SYNC = b"\x1a\xcf\xfc\x1d"  # CCSDS ASM


def main(device="cuda", small=False):
    with tempfile.TemporaryDirectory() as tmp:
        # --- CCSDS file with garbage between frames, recovered via sync
        frames = [ccsds_packet(apid=42, payload=f"obs-{i}".encode(),
                               sequence_count=i) for i in range(4)]
        blob = b"".join(b"\xde\xad" * 3 + SYNC + f for f in frames) \
            + b"\xff" * 7
        ccsds_path = os.path.join(tmp, "downlink.bin")
        with open(ccsds_path, "wb") as f:
            f.write(blob)

        parsed = Parser(Ccsds, sync_pattern=SYNC).parse_from_file(ccsds_path)
        print(f"CCSDS: {len(parsed)} frames recovered through sync resync")
        for p in parsed:
            print(f"  APID {p.apid} seq {p.sequence_count}: "
                  f"{p.payload.decode()}")

        # --- VITA49 file parsed with a per-frame callback
        v49 = [vita49_packet(payload=f"iq-chunk-{i}".encode().ljust(12,
                                                                    b"\0"),
                             stream_id=7) for i in range(3)]
        vita_path = os.path.join(tmp, "vita49.bin")
        with open(vita_path, "wb") as f:
            f.write(b"".join(v49))

        seen = []
        with open(vita_path, "rb") as f:
            data = f.read()
        for frame in Parser(Vita49).iter_frames(data):
            seen.append(frame)
            print(f"VITA49 stream {frame.stream_id}: "
                  f"{len(frame.payload)} payload bytes")
        print(f"VITA49: {len(seen)} frames")


if __name__ == "__main__":
    main()
