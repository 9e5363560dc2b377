"""Wire encodings (port of ballista_tpu/serde). Only the wire version of
persisted documents is ported; the plan and task codecs are not."""
