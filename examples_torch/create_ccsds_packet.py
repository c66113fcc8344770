"""Create and parse CCSDS space packets, with and without a
mission-specific config (reference: examples/create_ccsds_packet.zig +
create_ccsds_packet_config.zig + its JSON config; the PyTorch port of
examples/create_ccsds_packet.py). Host code only: ``device`` is not
used.

Run: ``python examples_torch/create_ccsds_packet.py``.
"""

from astroz_tpu_torch.io.ccsds import Ccsds, CcsdsConfig, build_packet


def main(device="cuda", small=False):
    # --- build a packet from scratch --------------------------------------
    payload = bytes(range(1, 11))
    raw = build_packet(apid=0x97, payload=payload, sequence_count=0,
                       packet_type=1)
    pkt = Ccsds.parse(raw)
    print("built packet:")
    print(f"  version={pkt.version} type={pkt.packet_type} "
          f"apid=0x{pkt.apid:03X} seq={pkt.sequence_count}")
    print(f"  payload={pkt.payload.hex()}")

    # --- parse with a mission config (JSON, like the reference's) ----------
    config = CcsdsConfig.from_json('{"secondaryHeaderLength": 12}')
    raw2 = build_packet(apid=0x97, payload=payload, sequence_count=1,
                        secondary_header=bytes(12))
    pkt2 = Ccsds.parse(raw2, config=config)
    print("\nwith 12-byte secondary header config:")
    print(f"  secondary header: {pkt2.secondary_header.hex()}")
    print(f"  payload:          {pkt2.payload.hex()}")

    # --- a raw telemetry frame (length field = data bytes - 1) -------------
    raw_ref = bytes([0x78, 0x97, 0xC0, 0x00, 0x00, 0x09,
                     1, 2, 3, 4, 5, 6, 7, 8, 9, 10])
    pkt3 = Ccsds.parse(raw_ref)
    print(f"\nreference test packet: apid=0x{pkt3.apid:03X} "
          f"len={len(pkt3.payload)} payload={pkt3.payload.hex()}")


if __name__ == "__main__":
    main()
