"""Telemetry ingestion: build, stream, and parse CCSDS packets over TCP
on the loopback interface (reference: parsers.zig TCP ingestion,
examples ccsds/vita49 demos; the PyTorch port of
examples/telemetry_pipeline.py). Host code only: ``device`` is not
used.

Run: ``python examples_torch/telemetry_pipeline.py``.
"""

import socket
import threading

from astroz_tpu_torch.io import Ccsds, Parser
from astroz_tpu_torch.io.ccsds import build_packet


def main(device="cuda", small=False):
    pkts = [build_packet(apid=100 + i, payload=f"frame-{i}".encode(),
                         sequence_count=i) for i in range(5)]

    with socket.socket() as server:
        server.bind(("127.0.0.1", 0))
        server.listen(1)
        port = server.getsockname()[1]

        def serve():
            conn, _ = server.accept()
            with conn:
                for p in pkts:
                    conn.sendall(p)

        sender = threading.Thread(target=serve, daemon=True)
        sender.start()
        frames = Parser(Ccsds).start(
            "127.0.0.1", port, max_frames=5,
            callback=lambda f: print(f"APID {f.apid}: {f.payload.decode()}"))
        sender.join(timeout=10)
    print(f"parsed {len(frames)} frames")


if __name__ == "__main__":
    main()
