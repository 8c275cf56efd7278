"""AWS S3 and EC2 through boto3.

Copy of ``magellanmapper_tpu/cloud/aws.py``: EC2 start, list and
terminate, S3 list, download (checked against the object's MD5 ETag),
upload and delete. boto3 is imported when a call needs it, so the module
imports without it; a call then raises the reference's ``ImportError``.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, List, Optional, Sequence

_logger = logging.getLogger(__name__)


def _boto3():
    try:
        import boto3
        return boto3
    except ImportError as exc:
        raise ImportError(
            "boto3 is required for AWS tasks; install boto3 or run the "
            "pipeline locally") from exc


def md5sum(path: str, blocksize: int = 1 << 20) -> str:
    """MD5 of a file (for S3 upload/download verification)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(blocksize), b""):
            h.update(chunk)
    return h.hexdigest()


def start_instances(
        image_id: str, instance_type: str, count: int = 1,
        key_name: Optional[str] = None, **kwargs) -> List[str]:
    """Launch EC2 instances (reference ``aws.py:82``)."""
    ec2 = _boto3().resource("ec2")
    instances = ec2.create_instances(
        ImageId=image_id, InstanceType=instance_type,
        MinCount=count, MaxCount=count,
        **({"KeyName": key_name} if key_name else {}), **kwargs)
    ids = [inst.id for inst in instances]
    _logger.info("started EC2 instances: %s", ids)
    return ids


def list_instances(state: str = "running") -> List[Dict]:
    """List EC2 instances (reference ``aws.py:154``)."""
    ec2 = _boto3().resource("ec2")
    out = []
    for inst in ec2.instances.filter(Filters=[
            {"Name": "instance-state-name", "Values": [state]}]):
        out.append({"id": inst.id, "type": inst.instance_type,
                    "ip": inst.public_ip_address})
    return out


def terminate_instances(instance_ids: Sequence[str]) -> None:
    """Terminate EC2 instances (reference ``aws.py:229``)."""
    ec2 = _boto3().resource("ec2")
    ec2.instances.filter(InstanceIds=list(instance_ids)).terminate()


def list_s3(bucket: str, prefix: str = "") -> List[str]:
    """List keys in a bucket (reference ``aws.py:306``)."""
    s3 = _boto3().resource("s3")
    return [obj.key for obj in
            s3.Bucket(bucket).objects.filter(Prefix=prefix)]


def download_s3(
        bucket: str, key: str, out_path: Optional[str] = None) -> str:
    """Download an object with MD5 check (reference ``aws.py:344``)."""
    s3 = _boto3().resource("s3")
    out_path = out_path or os.path.basename(key)
    obj = s3.Object(bucket, key)
    obj.download_file(out_path)
    etag = obj.e_tag.strip('"')
    if "-" not in etag and md5sum(out_path) != etag:
        raise IOError(f"MD5 mismatch downloading s3://{bucket}/{key}")
    return out_path


def upload_s3(path: str, bucket: str, key: Optional[str] = None) -> str:
    """Upload a file (reference ``aws.py:383``)."""
    s3 = _boto3().resource("s3")
    key = key or os.path.basename(path)
    s3.Bucket(bucket).upload_file(path, key)
    _logger.info("uploaded %s to s3://%s/%s", path, bucket, key)
    return key


def split_s3_path(path: str):
    """Split an ``s3://bucket/key`` path into (bucket, key)
    (reference ``aws.split_s3_path :170``)."""
    parts = path.split("/")
    bucket, key = None, None
    if len(parts) > 2:
        offset = 2 if parts[0].lower() == "s3:" else 0
        bucket = parts[offset]
        key = "/".join(parts[offset + 1:])
    return bucket, key


def instance_info(instance_id: str, get_ip: bool = False):
    """(instance_id, public_ip) for an EC2 instance
    (reference ``aws.instance_info :27``)."""
    boto3 = _boto3()
    ec2 = boto3.session.Session().resource("ec2")
    inst = ec2.Instance(instance_id)
    ip = None
    if get_ip:
        inst.wait_until_running()
        inst.load()
        ip = inst.public_ip_address
    return instance_id, ip


def show_instances(state: str = "running") -> List[Dict]:
    """Print and return instance summaries
    (reference ``aws.show_instances``)."""
    infos = list_instances(state)
    for info in infos:
        _logger.info("%s", info)
    return infos


def list_s3_bucket(bucket_name: str, keys: Optional[str] = None
                   ) -> List[str]:
    """Keys in a bucket with an optional prefix
    (reference ``aws.list_s3_bucket``)."""
    return list_s3(bucket_name, keys or "")


def load_s3_file(bucket_name: str, key):
    """Map keys to loaded S3 object handles
    (reference ``aws.load_s3_file :306``)."""
    boto3 = _boto3()
    s3 = boto3.resource("s3")
    out = {}
    for k in ([key] if isinstance(key, str) else key):
        obj = s3.Object(bucket_name, k)
        try:
            obj.load()
            out[k] = obj
        except Exception:
            _logger.warning("could not load s3://%s/%s", bucket_name, k)
    return out


def download_s3_file(bucket_name: str, key: str,
                     out_path: Optional[str] = None) -> str:
    """Download one key (reference ``aws.download_s3_file :344``)."""
    return download_s3(bucket_name, key, out_path)


def upload_s3_file(path: str, bucket_name: str,
                   key: Optional[str] = None) -> str:
    """Upload one file (reference ``aws.upload_s3_file :383``)."""
    return upload_s3(path, bucket_name, key)


def delete_s3_file(bucket_name: str, key: str,
                   hard: bool = False) -> bool:
    """Delete a key (and permanently purge versions when ``hard``)
    (reference ``aws.delete_s3_file``)."""
    boto3 = _boto3()
    s3 = boto3.resource("s3")
    if hard:
        bucket = s3.Bucket(bucket_name)
        bucket.object_versions.filter(Prefix=key).delete()
    else:
        s3.Object(bucket_name, key).delete()
    return True
