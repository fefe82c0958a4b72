from .fault import (ElasticPlan, FailureDetector, StragglerWatchdog,
                    plan_elastic_mesh)

__all__ = ["ElasticPlan", "FailureDetector", "StragglerWatchdog",
           "plan_elastic_mesh"]
