"""S3-compatible cloud stores (reference: blobstore/s3 — pooled multipart
S3Store s3_store.go:23-173, S3 Express PutIfNotExists CAS express_store.go:
40-126, DynamoDB conditional-write commit store ddb_commit_store.go:35-170;
blobstore/minio).

This environment has no cloud SDK / egress, so the client is injected: pass any
object with get_object/put_object/delete_object/list_objects (the boto3 S3
client surface) — production uses boto3, tests use a fake. All vecgo-level
semantics (multipart threshold, CAS manifests, conditional commit) live here
and are fully testable against the fake.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from vecgo_tpu_torch.blobstore import BlobStore
from vecgo_tpu_torch.errors import ErrConflict, ErrNotFound

MULTIPART_THRESHOLD = 64 * 1024 * 1024
MULTIPART_CHUNK = 16 * 1024 * 1024


def make_boto3_client(region: Optional[str] = None, endpoint_url: Optional[str] = None):
    """Build a real S3 client when boto3 is available (an optional dependency)."""
    try:
        import boto3  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "boto3 is not installed; inject a client object instead"
        ) from e
    return boto3.client("s3", region_name=region, endpoint_url=endpoint_url)


class S3Store(BlobStore):
    """Generic S3 store with multipart uploads for large blobs."""

    def __init__(self, client, bucket: str, prefix: str = ""):
        self.client = client
        self.bucket = bucket
        self.prefix = prefix.rstrip("/") + "/" if prefix else ""

    def _key(self, name: str) -> str:
        return self.prefix + name

    def put(self, name: str, data: bytes) -> None:
        if len(data) >= MULTIPART_THRESHOLD and hasattr(
            self.client, "create_multipart_upload"
        ):
            self._put_multipart(name, data)
        else:
            self.client.put_object(Bucket=self.bucket, Key=self._key(name), Body=data)

    def _put_multipart(self, name: str, data: bytes) -> None:
        key = self._key(name)
        mp = self.client.create_multipart_upload(Bucket=self.bucket, Key=key)
        upload_id = mp["UploadId"]
        parts = []
        try:
            for i, off in enumerate(range(0, len(data), MULTIPART_CHUNK)):
                resp = self.client.upload_part(
                    Bucket=self.bucket,
                    Key=key,
                    UploadId=upload_id,
                    PartNumber=i + 1,
                    Body=data[off : off + MULTIPART_CHUNK],
                )
                parts.append({"ETag": resp["ETag"], "PartNumber": i + 1})
            self.client.complete_multipart_upload(
                Bucket=self.bucket,
                Key=key,
                UploadId=upload_id,
                MultipartUpload={"Parts": parts},
            )
        except BaseException:
            self.client.abort_multipart_upload(
                Bucket=self.bucket, Key=key, UploadId=upload_id
            )
            raise

    def get(self, name: str) -> bytes:
        try:
            resp = self.client.get_object(Bucket=self.bucket, Key=self._key(name))
        except Exception as e:
            if _is_missing(e):
                raise ErrNotFound(name)
            raise
        body = resp["Body"]
        return body.read() if hasattr(body, "read") else body

    def get_range(self, name: str, offset: int, length: int) -> bytes:
        """Ranged GET via the HTTP `Range:` header — O(length) transfer
        (reference: blobstore reads behind diskann readBlock:1151)."""
        if length <= 0:
            return b""
        try:
            resp = self.client.get_object(
                Bucket=self.bucket,
                Key=self._key(name),
                Range=f"bytes={offset}-{offset + length - 1}",
            )
        except Exception as e:
            if _is_missing(e):
                raise ErrNotFound(name)
            raise
        body = resp["Body"]
        return body.read() if hasattr(body, "read") else body

    def delete(self, name: str) -> None:
        self.client.delete_object(Bucket=self.bucket, Key=self._key(name))

    def list(self, prefix: str = "") -> List[str]:
        out = []
        kwargs = {"Bucket": self.bucket, "Prefix": self._key(prefix)}
        while True:
            resp = self.client.list_objects_v2(**kwargs)
            for obj in resp.get("Contents", []):
                out.append(obj["Key"][len(self.prefix) :])
            if not resp.get("IsTruncated"):
                break
            kwargs["ContinuationToken"] = resp["NextContinuationToken"]
        return sorted(out)

    def size(self, name: str) -> int:
        try:
            resp = self.client.head_object(Bucket=self.bucket, Key=self._key(name))
        except Exception as e:
            if _is_missing(e):
                raise ErrNotFound(name)
            raise
        return int(resp["ContentLength"])


class S3ExpressStore(S3Store):
    """S3 Express One Zone: conditional PUT (If-None-Match: *) gives a real
    CAS for manifests (reference: express_store.go:94-126)."""

    def put_if_not_exists(self, name: str, data: bytes) -> None:
        try:
            self.client.put_object(
                Bucket=self.bucket,
                Key=self._key(name),
                Body=data,
                IfNoneMatch="*",
            )
        except Exception as e:
            if _is_precondition_failed(e):
                raise ErrConflict(f"blob {name} already exists")
            raise


class DDBCommitStore:
    """CURRENT-pointer commit via DynamoDB conditional writes — multi-writer
    safety when the object store lacks CAS (reference: ddb_commit_store.go:
    35-170). Wraps any BlobStore: data goes to the store, the CURRENT commit
    goes through a conditional DDB put keyed by db name + expected version."""

    def __init__(self, ddb_client, table: str, db_name: str):
        self.ddb = ddb_client
        self.table = table
        self.db_name = db_name

    def commit_version(self, version: int, expect_previous: Optional[int]) -> None:
        item = {
            "db": {"S": self.db_name},
            "version": {"N": str(version)},
        }
        kwargs = {"TableName": self.table, "Item": item}
        if expect_previous is None:
            kwargs["ConditionExpression"] = "attribute_not_exists(db)"
        else:
            kwargs["ConditionExpression"] = "version = :prev"
            kwargs["ExpressionAttributeValues"] = {":prev": {"N": str(expect_previous)}}
        try:
            self.ddb.put_item(**kwargs)
        except Exception as e:
            if _is_conditional_failed(e):
                raise ErrConflict(
                    f"commit of version {version} lost the race (expected prev "
                    f"{expect_previous})"
                )
            raise

    def current_version(self) -> Optional[int]:
        resp = self.ddb.get_item(
            TableName=self.table, Key={"db": {"S": self.db_name}}
        )
        item = resp.get("Item")
        return int(item["version"]["N"]) if item else None


def _code(e) -> str:
    return getattr(e, "response", {}).get("Error", {}).get("Code", "")


def _is_missing(e) -> bool:
    return _code(e) in ("NoSuchKey", "404", "NotFound") or isinstance(e, KeyError)


def _is_precondition_failed(e) -> bool:
    return _code(e) in ("PreconditionFailed", "412")


def _is_conditional_failed(e) -> bool:
    return _code(e) == "ConditionalCheckFailedException"


class MinioStore(S3Store):
    """MinIO-backed store (reference: blobstore/minio). MinIO speaks the S3
    API; the practical differences the reference encodes are (a) endpoint
    configuration and (b) no S3-Express conditional PUT — MinIO *does*
    honor `If-None-Match: *` on recent releases, so put_if_not_exists tries
    the conditional PUT and falls back to a non-atomic exists+put (callers
    needing multi-writer safety should pair MinIO with DDBCommitStore or an
    external lock, as the reference's docs advise)."""

    def __init__(self, client, bucket: str, prefix: str = ""):
        super().__init__(client, bucket, prefix)

    @staticmethod
    def make_client(endpoint_url: str, access_key: str = "", secret_key: str = ""):
        try:
            import boto3  # type: ignore
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "boto3 is not installed; inject a client object instead"
            ) from e
        return boto3.client(
            "s3", endpoint_url=endpoint_url,
            aws_access_key_id=access_key or None,
            aws_secret_access_key=secret_key or None,
        )

    def put_if_not_exists(self, name: str, data: bytes) -> None:
        try:
            self.client.put_object(
                Bucket=self.bucket, Key=self._key(name), Body=data,
                IfNoneMatch="*",
            )
            return
        except Exception as e:
            if _is_precondition_failed(e):
                raise ErrConflict(f"blob {name} already exists")
            # Server ignores/rejects the conditional header: fall back.
        if self.exists(name):
            raise ErrConflict(f"blob {name} already exists")
        self.put(name, data)
