"""Cloud stages: S3 and EC2 through boto3 (imported when called) and
webhook notifications."""
