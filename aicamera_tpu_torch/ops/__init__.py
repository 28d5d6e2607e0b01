"""Device image ops: letterbox (kernel + plain version), decode+NMS, crops."""
