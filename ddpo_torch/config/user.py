"""User-specific settings (reference: config/user.py holds the GCS bucket)."""

import os

# Destination for logs/checkpoints/datasets. Local directory by default so
# the framework runs end-to-end without GCS; point at a gs:// bucket for
# multi-host production runs (e.g. export DDPO_BUCKET=gs://my-bucket).
bucket = os.environ.get("DDPO_BUCKET", "logs-local")
