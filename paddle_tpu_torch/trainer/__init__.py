from . import checkpoint, evaluator, event, plot
from .elastic import ElasticMaster, ElasticWorker
from .checkpoint import (COMPLETE_MANIFEST, from_tar, latest_pass,
                         load_checkpoint, pass_dir, publish_members,
                         save_checkpoint, to_tar, verify_checkpoint)
from .evaluator import (AucEvaluator, ChunkEvaluator,
                        ClassificationErrorEvaluator, CTCErrorEvaluator,
                        DetectionMAPEvaluator, Evaluator,
                        EvaluatorGroup, MaxIdPrinterEvaluator,
                        PnpairEvaluator, PrecisionRecallEvaluator,
                        SumEvaluator, ValuePrinterEvaluator)
from .plot import Ploter
from .trainer import Trainer, shared_forward

__all__ = ["AucEvaluator", "CTCErrorEvaluator", "ChunkEvaluator",
           "ClassificationErrorEvaluator", "DetectionMAPEvaluator",
           "Evaluator", "EvaluatorGroup", "MaxIdPrinterEvaluator",
           "PnpairEvaluator", "Ploter", "PrecisionRecallEvaluator",
           "SumEvaluator", "Trainer", "ValuePrinterEvaluator", "checkpoint",
           "evaluator", "event", "latest_pass", "load_checkpoint", "plot",
           "save_checkpoint", "shared_forward", "verify_checkpoint",
           "to_tar", "from_tar", "pass_dir", "publish_members",
           "COMPLETE_MANIFEST", "ElasticMaster", "ElasticWorker"]
