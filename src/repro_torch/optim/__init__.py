"""AdamW with clipping, the cosine schedule, the tree fingerprint and int8
gradient compression."""
