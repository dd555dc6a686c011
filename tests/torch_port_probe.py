"""The bind semantics of this machine's network stack for a port held by
a socket that never listens, against the listeners a world binds there
(a plain ``SO_REUSEADDR`` listener, the world's TCPStore on both of its
backends), and whether abstract Unix names are exclusive.  It shows why
``horovod_tpu_torch.common.net`` sets ``SO_REUSEADDR`` on a hold before
its bind and locks each held port with an abstract Unix name.

    python tests/torch_port_probe.py

Holders: ``late`` sets ``SO_REUSEADDR`` after its bind, ``reuse`` before
it, ``plain`` never."""
import datetime, errno, os, platform, socket

def bind(port, reuse, listen=False, addr=""):
    s = socket.socket()
    if reuse:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind((addr, port))
        if listen:
            s.listen()
        return s
    except OSError as e:
        s.close()
        return errno.errorcode.get(e.errno, e.errno)

def holder(kind):
    s = socket.socket()
    if kind == "reuse":
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("", 0))
    if kind == "late":
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    return s

def ok(x):
    return "bound" if isinstance(x, socket.socket) else x

def store(port, libuv):
    import torch.distributed as dist
    try:
        st = dist.TCPStore("127.0.0.1", port, 1, True,
                           timeout=datetime.timedelta(seconds=5),
                           use_libuv=libuv)
        st.set("a", "b")
        return st, "served"
    except Exception as e:
        return None, type(e).__name__ + ": " + str(e)[:160]

print("uname", platform.uname())
print("version", open("/proc/version").read().strip())
print("range", open("/proc/sys/net/ipv4/ip_local_port_range").read().split())
import torch
print("torch", torch.__version__)
for kind in ("late", "reuse", "plain"):
    h = holder(kind)
    p = h.getsockname()[1]
    print(f"--- holder {kind} on {p}")
    print("  probe no reuse:", ok(bind(p, False)))
    r = bind(p, True)
    print("  second holder reuse (non-listening):", ok(r))
    if isinstance(r, socket.socket):
        r.close()
    L = bind(p, True, listen=True)
    print("  reuse listener:", ok(L))
    if isinstance(L, socket.socket):
        print("    while listening, reuse bind:", ok(bind(p, True)),
              "probe:", ok(bind(p, False)))
        L.close()
    L4 = bind(p, True, listen=True, addr="127.0.0.1")
    print("  reuse listener on 127.0.0.1:", ok(L4))
    if isinstance(L4, socket.socket):
        L4.close()
    for libuv in (True, False):
        st, res = store(p, libuv)
        print(f"  TCPStore libuv={libuv}:", res)
        del st
    h.close()
# The store's own listener: does it set SO_REUSEADDR?
q = holder("plain"); port = q.getsockname()[1]; q.close()
for libuv in (True, False):
    st, res = store(port, libuv)
    seen = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            s = socket.socket(fileno=os.dup(int(fd)))
        except OSError:
            continue
        try:
            if s.family in (socket.AF_INET, socket.AF_INET6) and s.getsockname()[1] == port:
                seen.append((s.family.name, s.getsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR),
                             s.getsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT),
                             s.getsockopt(socket.SOL_SOCKET, socket.SO_ACCEPTCONN)))
        except OSError:
            pass
        s.close()
    print(f"store libuv={libuv} {res}: listener sockets (family, reuseaddr, reuseport, listening)", seen)
    del st
    import time; time.sleep(0.5)
# Abstract unix names as a lock.
a = socket.socket(socket.AF_UNIX); a.bind("\0hvd-probe-lock-1")
b = socket.socket(socket.AF_UNIX)
try:
    b.bind("\0hvd-probe-lock-1"); print("abstract unix: second bind succeeded")
except OSError as e:
    print("abstract unix: second bind", errno.errorcode.get(e.errno))
