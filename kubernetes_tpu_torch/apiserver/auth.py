"""AuthN/Z for the apiserver write path (pkg/auth + plugin/pkg/auth,
scheduler-relevant slice).

Authentication: static token file, the reference's tokenfile authenticator
(plugin/pkg/auth/authenticator/token/tokenfile) — CSV lines of
``token,user,uid[,group1|group2]``; requests carry
``Authorization: Bearer <token>``.

Authorization: ABAC-lite (pkg/auth/authorizer/abac): an ordered list of
policy dicts ``{"user": ..., "group": ..., "resource": ..., "readonly":
bool}`` — empty/"*" fields match anything; a request is allowed if ANY
policy matches (readonly policies only allow GET).  The file format is the
reference's one-JSON-object-per-line policy file.

Both are OFF unless configured — matching the reference's default
insecure port — and wired in front of the handler chain
(auth -> admission -> validation -> registry, pkg/apiserver).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class UserInfo:
    name: str
    uid: str = ""
    groups: tuple[str, ...] = ()


class AuthenticationError(Exception):
    """No/unknown credentials -> 401."""


class TokenAuthenticator:
    """tokenfile.TokenAuthenticator: token -> UserInfo."""

    def __init__(self, tokens: dict[str, UserInfo]):
        self._tokens = dict(tokens)

    @classmethod
    def from_file(cls, path: str) -> "TokenAuthenticator":
        tokens: dict[str, UserInfo] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) < 3:
                    raise ValueError(
                        f"token file line needs token,user,uid: {line!r}")
                groups = tuple(g for g in parts[3].split("|")) \
                    if len(parts) > 3 and parts[3] else ()
                tokens[parts[0]] = UserInfo(name=parts[1], uid=parts[2],
                                            groups=groups)
        return cls(tokens)

    def authenticate(self, authorization: str) -> UserInfo:
        """``Authorization: Bearer <token>`` -> UserInfo or raises."""
        scheme, _, token = authorization.partition(" ")
        if scheme.lower() != "bearer" or not token.strip():
            raise AuthenticationError("expected a bearer token")
        user = self._tokens.get(token.strip())
        if user is None:
            raise AuthenticationError("unknown token")
        return user


SA_TOKEN_TYPE = "kubernetes.io/service-account-token"
SA_NAME_ANNOTATION = "kubernetes.io/service-account.name"


def serviceaccount_username(namespace: str, name: str) -> str:
    """pkg/serviceaccount MakeUsername."""
    return f"system:serviceaccount:{namespace}:{name}"


class ServiceAccountAuthenticator:
    """ServiceAccount token authentication (pkg/serviceaccount/jwt.go's
    role): a bearer token is valid iff a live Secret of type
    ``kubernetes.io/service-account-token`` carries it, and resolves to
    the SA identity ``system:serviceaccount:<ns>:<name>`` with the
    ``system:serviceaccounts`` group pair.  Where the reference verifies
    a JWT signature offline, this store-backed check gives the same
    revocation story the reference ALSO enforces (tokens die with their
    secret, jwt.go lookup = true path)."""

    def __init__(self, store):
        self._store = store
        # token -> (namespace, sa_name), maintained from a secrets
        # watch: the authenticator sits on the request hot path, and an
        # O(all-secrets) scan per bearer token would grow with the
        # cluster.  Started lazily so constructing the authenticator
        # stays side-effect free.
        import threading
        self._index: dict[str, tuple[str, str]] = {}
        self._index_lock = threading.Lock()
        self._reflector = None
        self._ready = threading.Event()

    def _on_secret(self, etype: str, obj: dict) -> None:
        if obj.get("type") != SA_TOKEN_TYPE:
            return
        meta = obj.get("metadata") or {}
        token = (obj.get("data") or {}).get("token")
        sa_name = (meta.get("annotations") or {}).get(
            SA_NAME_ANNOTATION, "")
        if not token or not sa_name:
            return
        with self._index_lock:
            if etype == "DELETED":
                self._index.pop(token, None)
            else:
                self._index[token] = (meta.get("namespace", "default"),
                                      sa_name)

    def _ensure_watch(self) -> None:
        if self._ready.is_set():
            return
        with self._index_lock:
            starter = self._reflector is None
            if starter:
                from kubernetes_tpu_torch.client.reflector import Reflector
                self._reflector = Reflector(self._store, "secrets",
                                            self._on_secret)
        if starter:
            # run() outside the index lock: the initial list delivers
            # through _on_secret, which takes it.
            self._reflector.run()
            self._reflector.wait_for_sync()
            self._ready.set()
        else:
            self._ready.wait(timeout=10)

    def authenticate(self, authorization: str) -> UserInfo:
        scheme, _, token = authorization.partition(" ")
        token = token.strip()
        if scheme.lower() != "bearer" or not token:
            raise AuthenticationError("expected a bearer token")
        try:
            self._ensure_watch()
        except Exception as err:  # noqa: BLE001 — store unreadable: 401
            raise AuthenticationError("token lookup failed") from err
        with self._index_lock:
            hit = self._index.get(token)
        if hit is None:
            raise AuthenticationError("unknown token")
        ns, sa_name = hit
        return UserInfo(
            name=serviceaccount_username(ns, sa_name),
            groups=("system:serviceaccounts",
                    f"system:serviceaccounts:{ns}"))


class BasicAuthenticator:
    """HTTP basic auth from a password file (plugin/pkg/auth/
    authenticator/password/passwordfile): CSV lines of
    ``password,user,uid[,group1|group2]``; requests carry
    ``Authorization: Basic base64(user:password)``."""

    def __init__(self, entries: dict[str, tuple[str, UserInfo]]):
        # user -> (password, UserInfo)
        self._entries = dict(entries)

    @classmethod
    def from_file(cls, path: str) -> "BasicAuthenticator":
        entries: dict[str, tuple[str, UserInfo]] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) < 3:
                    raise ValueError(
                        f"basic-auth line needs password,user,uid: "
                        f"{line!r}")
                groups = tuple(parts[3].split("|")) \
                    if len(parts) > 3 and parts[3] else ()
                entries[parts[1]] = (parts[0], UserInfo(
                    name=parts[1], uid=parts[2], groups=groups))
        return cls(entries)

    def authenticate(self, authorization: str) -> UserInfo:
        import base64
        import hmac
        scheme, _, blob = authorization.partition(" ")
        if scheme.lower() != "basic" or not blob.strip():
            raise AuthenticationError("expected basic credentials")
        try:
            user, _, password = base64.b64decode(
                blob.strip()).decode().partition(":")
        except Exception as err:  # noqa: BLE001 — garbage b64
            raise AuthenticationError("malformed basic credentials") \
                from err
        entry = self._entries.get(user)
        # Constant-time compare on BYTES (str compare_digest rejects
        # non-ASCII with a TypeError — a remotely triggerable crash);
        # an unknown user burns the same compare so the 401 timing
        # doesn't enumerate accounts.
        expected = entry[0] if entry else ""
        if not hmac.compare_digest(password.encode(),
                                   expected.encode()) or entry is None:
            raise AuthenticationError("invalid user/password")
        return entry[1]


class WebhookTokenAuthenticator:
    """Token-review webhook (plugin/pkg/auth/authenticator/token/
    webhook): POST a TokenReview to the configured URL; the remote
    answers ``status.authenticated`` + ``status.user``.  Positive AND
    negative verdicts are cached with a TTL (the reference's
    cached_token_authenticator) so a chatty client doesn't hammer the
    webhook."""

    def __init__(self, url: str, cache_ttl: float = 120.0,
                 timeout: float = 5.0):
        import threading
        self.url = url
        self.cache_ttl = cache_ttl
        self.timeout = timeout
        self._cache: dict[str, tuple[float, Optional[UserInfo]]] = {}
        self._lock = threading.Lock()

    def authenticate(self, authorization: str) -> UserInfo:
        import time
        scheme, _, token = authorization.partition(" ")
        token = token.strip()
        if scheme.lower() != "bearer" or not token:
            raise AuthenticationError("expected a bearer token")
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(token)
            if hit is not None and now - hit[0] < self.cache_ttl:
                if hit[1] is None:
                    raise AuthenticationError("token rejected (cached)")
                return hit[1]
        user = self._review(token)
        with self._lock:
            self._cache[token] = (now, user)
            if len(self._cache) > 4096:  # bound the negative cache
                self._cache.pop(next(iter(self._cache)))
        if user is None:
            raise AuthenticationError("token rejected by webhook")
        return user

    def _review(self, token: str) -> Optional[UserInfo]:
        import urllib.request
        body = json.dumps({
            "apiVersion": "authentication.k8s.io/v1beta1",
            "kind": "TokenReview",
            "spec": {"token": token}}).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                answer = json.loads(resp.read() or b"{}")
        except Exception as err:  # noqa: BLE001 — webhook down: 401
            raise AuthenticationError(
                f"token webhook unavailable: {err}") from err
        status = answer.get("status") or {}
        if not status.get("authenticated"):
            return None
        u = status.get("user") or {}
        return UserInfo(name=u.get("username", "") or "system:anonymous",
                        uid=str(u.get("uid", "")),
                        groups=tuple(u.get("groups") or ()))


class WebhookAuthorizer:
    """SubjectAccessReview webhook (plugin/pkg/auth/authorizer/webhook):
    POST the request's attributes; the remote answers
    ``status.allowed``.  Verdicts cached with a TTL (the reference's
    authorized/unauthorized TTL pair)."""

    def __init__(self, url: str, cache_ttl: float = 60.0,
                 timeout: float = 5.0):
        import threading
        self.url = url
        self.cache_ttl = cache_ttl
        self.timeout = timeout
        self._cache: dict[tuple, tuple[float, bool]] = {}
        self._lock = threading.Lock()

    def authorize(self, user: UserInfo, verb: str, resource: str,
                  namespace: str = "") -> bool:
        import time
        import urllib.request
        rbac_verb = _METHOD_VERBS.get(verb, verb.lower())
        key = (user.name, user.groups, rbac_verb, resource, namespace)
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and now - hit[0] < self.cache_ttl:
                return hit[1]
        body = json.dumps({
            "apiVersion": "authorization.k8s.io/v1beta1",
            "kind": "SubjectAccessReview",
            "spec": {"user": user.name, "groups": list(user.groups),
                     "resourceAttributes": {
                         "verb": rbac_verb, "resource": resource,
                         "namespace": namespace}}}).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                answer = json.loads(resp.read() or b"{}")
            allowed = bool((answer.get("status") or {}).get("allowed"))
        except Exception:  # noqa: BLE001 — webhook down: deny
            return False
        with self._lock:
            self._cache[key] = (now, allowed)
            if len(self._cache) > 4096:
                self._cache.pop(next(iter(self._cache)))
        return allowed


class UnionAuthenticator:
    """union.AuthenticatorRequest: first authenticator to accept wins;
    401 only when every one refuses."""

    def __init__(self, *authenticators):
        self._authenticators = [a for a in authenticators if a is not None]

    def authenticate(self, authorization: str) -> UserInfo:
        last: Exception = AuthenticationError("no authenticators")
        for a in self._authenticators:
            try:
                return a.authenticate(authorization)
            except AuthenticationError as err:
                last = err
        raise last


@dataclass
class ABACAuthorizer:
    """abac.PolicyList.Authorize: any matching policy allows."""

    policies: list[dict] = field(default_factory=list)

    @classmethod
    def from_file(cls, path: str) -> "ABACAuthorizer":
        policies = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                policies.append(json.loads(line))
        return cls(policies)

    def authorize(self, user: UserInfo, verb: str, resource: str) -> bool:
        readonly_verb = verb in ("GET", "HEAD")
        for p in self.policies:
            pu = p.get("user", "")
            pg = p.get("group", "")
            if pu and pu != "*" and pu != user.name:
                continue
            if pg and pg != "*" and pg not in user.groups:
                continue
            pr = p.get("resource", "")
            if pr and pr != "*" and pr != resource:
                continue
            if p.get("readonly", False) and not readonly_verb:
                continue
            return True
        return False


def user_from_cert(cert: dict) -> UserInfo:
    """x509 request authenticator (plugin/pkg/auth/authenticator/request/
    x509 CommonNameUserConversion): a VERIFIED client certificate's
    subject CN is the user name; O entries become groups."""
    cn = ""
    orgs: list[str] = []
    for rdn in cert.get("subject", ()):
        for key, value in rdn:
            if key == "commonName":
                cn = value
            elif key == "organizationName":
                orgs.append(value)
    return UserInfo(name=cn or "system:anonymous", groups=tuple(orgs))


# HTTP method -> RBAC verb (pkg/apiserver request attribute mapping).
_METHOD_VERBS = {"GET": "get", "POST": "create", "PUT": "update",
                 "DELETE": "delete", "HEAD": "get"}

# The reference's superuser convention: system:masters bypasses RBAC
# (pkg/registry + the --authorization-rbac-super-user bootstrap) — without
# it an RBAC-only apiserver could never receive its first RoleBinding.
SUPER_GROUP = "system:masters"


class RBACAuthorizer:
    """Alpha RBAC (pkg/apis/rbac; plugin/pkg/auth/authorizer/rbac):
    Roles/ClusterRoles hold rules {verbs, resources}; RoleBindings/
    ClusterRoleBindings grant them to User/Group subjects.  Reads the
    live objects from the store on every check — a kubectl-created
    binding takes effect immediately, like the reference's informers."""

    def __init__(self, store):
        self._store = store

    @staticmethod
    def _rule_covers(rule: dict, verb: str, resource: str) -> bool:
        verbs = rule.get("verbs") or []
        resources = rule.get("resources") or []
        return ("*" in verbs or verb in verbs) and \
            ("*" in resources or resource in resources)

    @staticmethod
    def _subject_matches(subj: dict, user: UserInfo) -> bool:
        kind = subj.get("kind", "User")
        name = subj.get("name", "")
        if kind == "User":
            return name == "*" or name == user.name
        if kind == "Group":
            return name in user.groups
        if kind == "ServiceAccount":
            # pkg/apis/rbac validation REQUIRES namespace on SA
            # subjects; silently defaulting it would make a forgetful
            # ClusterRoleBinding grant to default/<name> — a different
            # principal than intended.  No namespace, no match.
            ns = subj.get("namespace")
            if not ns:
                return False
            return user.name == serviceaccount_username(ns, name)
        return False

    def _role_rules(self, ref: dict, namespace: str) -> list[dict]:
        kind = ref.get("kind", "Role")
        name = ref.get("name", "")
        if kind == "ClusterRole":
            obj = self._store.get("clusterroles", name)
        else:
            obj = self._store.get("roles", f"{namespace}/{name}")
        return (obj or {}).get("rules") or []

    def authorize(self, user: UserInfo, verb: str, resource: str,
                  namespace: str = "") -> bool:
        if SUPER_GROUP in user.groups:
            return True
        rbac_verb = _METHOD_VERBS.get(verb, verb.lower())
        try:
            crbs, _ = self._store.list("clusterrolebindings")
            # A RoleBinding authorizes ONLY inside its own namespace: a
            # namespace-less request (cluster-scoped resource or flat
            # cluster-wide list) is judged by ClusterRoleBindings alone —
            # otherwise one team-a grant would leak cluster-wide reads.
            if namespace:
                rbs, _ = self._store.list(
                    "rolebindings",
                    lambda o: (o.get("metadata") or {})
                    .get("namespace", "default") == namespace)
            else:
                rbs = []
        except Exception:  # noqa: BLE001 — store unreadable: deny
            return False
        for binding, cluster_scoped in \
                [(b, True) for b in crbs] + [(b, False) for b in rbs]:
            subjects = binding.get("subjects") or []
            if not any(self._subject_matches(s, user) for s in subjects):
                continue
            ref = binding.get("roleRef") or {}
            # A ClusterRoleBinding may only reference a ClusterRole
            # (pkg/apis/rbac/validation): resolving a namespaced Role
            # against the binding's own namespace would grant
            # cluster-wide authority from a namespace-scoped object.
            if cluster_scoped and ref.get("kind", "Role") != "ClusterRole":
                continue
            bns = (binding.get("metadata") or {}).get(
                "namespace", "default")
            for rule in self._role_rules(ref, bns):
                if self._rule_covers(rule, rbac_verb, resource):
                    return True
        return False


@dataclass
class AuthConfig:
    """The chain the server consults; either part may be absent."""

    authenticator: Optional[TokenAuthenticator] = None
    authorizer: Optional[object] = None   # ABACAuthorizer | RBACAuthorizer
    # --anonymous-auth analogue: with it on, a request carrying NO
    # credentials proceeds as system:anonymous for the authorizer to
    # judge (the x509-only secure port's behavior); off, a configured
    # authenticator 401s credential-less requests (the tokenfile
    # server's behavior).
    anonymous: bool = False

    def check(self, authorization: str, verb: str, resource: str,
              namespace: str = "",
              peer_user: Optional[UserInfo] = None
              ) -> Optional[tuple[int, str]]:
        """None = allowed; else (status, message).  ``peer_user`` is a
        verified-client-cert identity (x509 authenticator): it outranks
        the token layer, as the reference's request-auth union does."""
        user = peer_user
        if user is None and self.authenticator is not None and \
                (authorization or not self.anonymous):
            # Credentials present must authenticate; with anonymous auth
            # off, absent credentials fail the same way (401).
            try:
                user = self.authenticator.authenticate(authorization)
            except AuthenticationError as err:
                return 401, str(err)
        if self.authorizer is not None:
            if user is None:
                user = UserInfo(name="system:anonymous")
            if isinstance(self.authorizer,
                          (RBACAuthorizer, WebhookAuthorizer)):
                allowed = self.authorizer.authorize(user, verb, resource,
                                                    namespace)
            else:
                allowed = self.authorizer.authorize(user, verb, resource)
            if not allowed:
                return 403, (f"user {user.name!r} is not allowed to "
                             f"{verb} {resource}")
        return None
