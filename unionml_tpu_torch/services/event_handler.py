"""Serverless event handler: drive predictions from API-Gateway / storage events.

A port of ``unionml_tpu/services/event_handler.py`` over the port's serving
helpers. Reference parity: the AWS-Lambda pattern the reference ships via templates and tests
(``tests/unit/test_aws_lambda_handler.py`` drives Mangum with synthetic API-Gateway and
S3 event payloads). Here the handler is framework-owned and dependency-free: it
understands HTTP-style events (API Gateway v1/v2 shapes) carrying the same
``{"features": ...}`` / ``{"inputs": ...}`` body as the HTTP server, and storage-style
events whose records reference feature files (routed through the dataset's
``feature_loader`` via ``pathlib.Path``).
"""

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.app import jsonable, load_model_artifact


def _http_body(event: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Extract a JSON body from API-Gateway v1/v2-shaped events."""
    if "body" not in event:
        return None
    body = event["body"]
    if body is None:
        return {}
    if isinstance(body, str):
        try:
            return json.loads(body)
        except json.JSONDecodeError:
            return None
    return body


def _storage_paths(event: Dict[str, Any]) -> List[str]:
    """Extract object paths from storage-notification-shaped events (s3/gcs records)."""
    paths = []
    for record in event.get("Records", []):
        s3 = record.get("s3")
        if s3:
            paths.append(f"{s3['bucket']['name']}/{s3['object']['key']}")
            continue
        if "bucket" in record and "name" in record:
            paths.append(f"{record['bucket']}/{record['name']}")
    return paths


def make_event_handler(
    model: Any,
    model_path: Optional[str] = None,
    path_resolver: Optional[Callable[[str], Path]] = None,
) -> Callable[[Dict[str, Any], Any], Dict[str, Any]]:
    """Build a ``handler(event, context)`` callable for serverless runtimes.

    :param model_path: optional explicit model file; defaults to ``UNIONML_MODEL_PATH``.
    :param path_resolver: maps a storage object path (``bucket/key``) to a local
        ``Path`` holding the downloaded features (inject your blob client here).
    """

    def handler(event: Dict[str, Any], context: Any = None) -> Dict[str, Any]:
        try:
            load_model_artifact(model, model_path=model_path)
        except Exception as exc:
            logger.exception("Model load failed")
            return {"statusCode": 500, "body": json.dumps({"detail": f"Model load failed: {exc}"})}

        try:
            body = _http_body(event)
            if body is None and isinstance(event.get("body"), str):
                return {"statusCode": 400, "body": json.dumps({"detail": "Request body must be valid JSON."})}
            if body is not None:
                inputs = body.get("inputs")
                features = body.get("features")
                if inputs is None and features is None:
                    return {
                        "statusCode": 500,
                        "body": json.dumps({"detail": "inputs or features must be supplied."}),
                    }
                predictions = model.predict(**inputs) if inputs else model.predict(features=features)
                return {"statusCode": 200, "body": json.dumps(jsonable(predictions))}

            paths = _storage_paths(event)
            if paths:
                results = {}
                for object_path in paths:
                    local = path_resolver(object_path) if path_resolver else Path(object_path)
                    results[object_path] = jsonable(model.predict(features=local))
                return {"statusCode": 200, "body": json.dumps(results)}

            return {"statusCode": 400, "body": json.dumps({"detail": "Unrecognized event shape."})}
        except Exception as exc:
            logger.exception("Prediction failed")
            return {"statusCode": 500, "body": json.dumps({"detail": f"Prediction failed: {exc}"})}

    return handler
