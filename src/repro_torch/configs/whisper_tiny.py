"""whisper-tiny [audio]: enc-dec, 4L each, d_model=384 6H d_ff=1536
vocab=51865 — conv frontend stubbed (input_specs provides log-mel frame
embeddings). decode_32k exceeds the published 448 max target positions; the
position table is sized from the shape config for the dry-run (DESIGN.md).
[arXiv:2212.04356; unverified]"""
from repro_torch.config.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51_865,
    layer_pattern="g",
    encdec=True,
    enc_layers=4,
    enc_seq=1500,
    rope_theta=0.0,            # learned absolute positions
    notes="conv frontend stubbed; learned positions sized per shape",
)
