"""BentoML service definition for {{app_name}} (`bentofile.yaml` points here)."""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from app import model

from unionml_tpu_torch.services.bentoml_service import BentoMLService

# the runnable's resident predictor runs on the card; UNIONML_DEVICE=cpu runs it on the CPU
service = BentoMLService(model, device=os.environ.get("UNIONML_DEVICE", "cuda"))
# bentoml tags must be lowercase; the app name is any valid Python identifier
BENTO_NAME = "{{app_name}}".lower()
svc = service.configure(f"{BENTO_NAME}:latest", name=BENTO_NAME)
