from .anomaly import (AlertEngine, AlertRule, AlertsConfig, AnomalyConfig,
                      AnomalyPlane)
from .base import (ActivationEntry, ActiveAckTimeout, CommonLoadBalancer,
                   InvokerHealth, LoadBalancer, LoadBalancerException,
                   LoadBalancerThrottleException,
                   HEALTHY, UNHEALTHY, UNRESPONSIVE, OFFLINE)
from .flight_recorder import (BatchRecord, FlightRecorder,
                              FlightRecorderConfig)
from .lean import LeanBalancer, LeanBalancerProvider
from .supervision import InvokerPool
from .telemetry import SloConfig, TelemetryConfig, TelemetryPlane
from .sharding_balancer import ShardingBalancer, ShardingBalancerProvider
from .tpu_balancer import TpuBalancer, TpuBalancerProvider

__all__ = [n for n in dir() if not n.startswith("_")]
