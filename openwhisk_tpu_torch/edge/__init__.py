"""Edge layer: reverse proxy in front of the controller pool.
A copy of `openwhisk_tpu/edge/__init__.py`.

Rebuild of the reference's nginx role (ansible/roles/nginx/templates/
nginx.conf.j2): TLS termination, controller upstream pool with failover,
namespace-subdomain vanity rewrite to /api/v1/web/..., API-gateway route
dispatch (the role the external API gateway plays in the reference), and
/metrics denial.
"""
from .proxy import EdgeProxy, Upstream

__all__ = ["EdgeProxy", "Upstream"]
