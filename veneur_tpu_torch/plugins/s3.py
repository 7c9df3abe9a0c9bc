"""S3 archive plugin (reference plugins/s3/s3.go): posts each flush's
InterMetrics as `<hostname>/<timestamp>.tsv.gz` (s3.go:90 S3Path).

boto3 is not part of this image, so the S3 client is injectable: pass any
object with `put_object(Bucket=, Key=, Body=)` (boto3's S3 client
signature). Without one, construction requires boto3 and raises cleanly —
the factory only wires this plugin when aws_* keys are configured.
"""

from __future__ import annotations

import logging
import time

from veneur_tpu_torch.sinks.localfile import encode_intermetrics_csv

log = logging.getLogger("veneur_tpu_torch.plugins.s3")


class S3Plugin:
    name = "s3"

    def __init__(self, bucket: str, region: str, hostname: str,
                 access_key_id: str = "", secret_access_key: str = "",
                 interval_s: int = 10, client=None, staging_dir: str = ""):
        self.bucket = bucket
        self.hostname = hostname
        self.interval_s = interval_s
        # optional durable staging: each flush's object is written
        # locally (atomic temp + rename) BEFORE the network put and
        # unlinked only after S3 acknowledges — a crash or failed upload
        # leaves a complete .tsv.gz an operator can re-upload, never a
        # torn one (README §Durability)
        self.staging_dir = staging_dir
        if client is None:
            try:
                import boto3  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "S3 plugin requires boto3 or an injected client") from e
            client = boto3.client(
                "s3", region_name=region,
                aws_access_key_id=access_key_id or None,
                aws_secret_access_key=secret_access_key or None)
        self.client = client

    def s3_path(self, ts: int, ext: str = "tsv.gz") -> str:
        """reference plugins/s3/s3.go:90: <hostname>/<unix_ts>.<ext>."""
        return f"{self.hostname}/{ts}.{ext}"

    def flush(self, metrics):
        import os
        ts = int(time.time())
        body = encode_intermetrics_csv(metrics, self.hostname,
                                       self.interval_s, compress=True)
        staged = None
        if self.staging_dir:
            from veneur_tpu_torch.utils.atomicio import atomic_write_bytes
            os.makedirs(self.staging_dir, exist_ok=True)
            staged = os.path.join(self.staging_dir, f"{ts}.tsv.gz")
            atomic_write_bytes(staged, body)
        self.client.put_object(Bucket=self.bucket,
                               Key=self.s3_path(ts), Body=body)
        if staged is not None:
            # acknowledged upload: the staged copy has served its purpose
            try:
                os.unlink(staged)
            except OSError:
                pass

    # see LocalFilePlugin: materialize, but don't veto the frame path
    accepts_frames = True

    def flush_frame(self, frame):
        self.flush(frame.intermetrics())
