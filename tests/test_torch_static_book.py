"""The Fluid book's programs built and trained by `paddle_tpu_torch.fluid`
and held against `paddle_tpu.fluid` on the CPU: fit_a_line
(`tests/test_book_suite.py:29-71`, SGD), recognize_digits as LeNet-5
(`tests/test_book_mnist.py:28-38`, Adam) and as the book's MLP (fc 200
relu x 2, fc 10 softmax, ``cross_entropy``, Adam),
image_classification's VGG-lite (`tests/test_book_suite.py:261-275`,
batch_norm + dropout, Adam), word2vec (`:74-116`: four lookups of one
shared table, ``concat``, Adam) and recommender_system (`:208-252`: two
embedding towers, ``concat``, fc tanh, ``cos_sim``, Adam), each over
the book's data readers (the `imikolov` and `movielens` datasets
bitwise JAX's too).

For each program:
* both packages build it dict for dict, main and startup;
* the JAX package's initialized weights, perturbed so that zero
  biases, unit scales and the running statistics carry values, reach
  the port through `fluid.io.save_persistables` / `load_persistables`
  (the saved-directory format), running statistics included;
* three training steps (dropout 0), each taken by both packages from
  JAX's state before it, give JAX's losses and accuracies within 1e-5
  and each gradient within 1e-4 of its scale (max |value|); after each
  step every parameter, optimizer state and running statistic lies
  within 1e-4 of its scale of JAX's, or of JAX's update of the same
  state from the port's gradients (below); the running statistics
  move, in the scope's own tensors;
* `save_inference_model` / `load_inference_model` of the trained
  program serve JAX's test-clone outputs (1e-5), the port's Predictor
  serves a directory the JAX package saved likewise, and with
  ``batch_norm_act_fuse`` and ``matmul_bias_act_fuse`` it serves the
  unfused run's (1e-5); the recommender's two tanh towers become
  ``matmul_bias_act`` there.

A bias added right before a ``batch_norm`` has a gradient of 0 in
exact arithmetic: both packages' gradients are rounding noise (~1e-9),
held under 1e-4 of the step's largest gradient, not to each other.
Adam's first step turns such a gradient into +-lr (lr g / (|g| + 1e-8)),
its sign the noise's, so the port's parameters may also lie at JAX's
update of the port's own gradients.  The state is carried into the port
before each step because Adam's normalization spreads that difference:
a later step's element whose moment has cancelled to near zero moves by
a share of lr for a gradient difference far inside 1e-4 of its scale.

"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as jun
import paddle_tpu_torch as ptt
from paddle_tpu_torch import fluid, inference
from paddle_tpu_torch.fluid import ir, layers, unique_name

from torch_static_common import jax_state_unchanged

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
SCALE_REL = 1e-4
FWD = dict(rtol=1e-5, atol=1e-5)
STEPS = 3


@pytest.fixture(autouse=True)
def _leaves_jax_state_as_found():
    with jax_state_unchanged():
        yield


# ---------------------------------------------------------------------------
# the programs, written once against either package's layers
# ---------------------------------------------------------------------------

def fit_a_line(pkg, L):
    x = L.data("x", shape=[13])
    y = L.data("y", shape=[1])
    pred = L.fc(x, size=1)
    avg = L.mean(L.square_error_cost(pred, y))
    return avg, None, pred, pkg.optimizer.SGDOptimizer(learning_rate=0.01)


def lenet5(pkg, L):
    img = L.data("img", shape=[1, 28, 28])
    label = L.data("label", shape=[1], dtype="int64")
    conv1 = L.conv2d(img, num_filters=6, filter_size=5, padding=2,
                     act="relu")
    pool1 = L.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = L.conv2d(pool1, num_filters=16, filter_size=5, act="relu")
    pool2 = L.pool2d(conv2, pool_size=2, pool_stride=2)
    fc1 = L.fc(pool2, size=120, act="relu")
    fc2 = L.fc(fc1, size=84, act="relu")
    logits = L.fc(fc2, size=10)
    avg = L.mean(L.softmax_with_cross_entropy(logits, label))
    acc = L.accuracy(L.softmax(logits), label)
    return avg, acc, logits, pkg.optimizer.AdamOptimizer(learning_rate=1e-3)


def mnist_mlp(pkg, L):
    img = L.data("img", shape=[1, 28, 28])
    label = L.data("label", shape=[1], dtype="int64")
    h = L.fc(img, size=200, act="relu")
    h = L.fc(h, size=200, act="relu")
    pred = L.fc(h, size=10, act="softmax")
    avg = L.mean(L.cross_entropy(pred, label))
    acc = L.accuracy(pred, label)
    return avg, acc, pred, pkg.optimizer.AdamOptimizer(learning_rate=1e-3)


def vgg_lite(pkg, L):
    img = L.data("img", shape=[3, 32, 32])
    label = L.data("label", shape=[1], dtype="int64")
    c1 = L.conv2d(img, num_filters=16, filter_size=3, padding=1, act="relu")
    p1 = L.pool2d(c1, pool_size=2, pool_stride=2)
    c2 = L.conv2d(p1, num_filters=32, filter_size=3, padding=1, act="relu")
    p2 = L.pool2d(c2, pool_size=2, pool_stride=2)
    bn = L.batch_norm(L.fc(p2, size=64), act="relu")
    logits = L.fc(L.dropout(bn, 0.0), size=10)
    avg = L.mean(L.softmax_with_cross_entropy(logits, label))
    acc = L.accuracy(L.softmax(logits), label)
    return avg, acc, logits, pkg.optimizer.AdamOptimizer(learning_rate=2e-3)


W2V_EMB, W2V_HID, W2V_N = 16, 64, 5
MOVIELENS = ["user_id", "gender", "age", "job", "movie_id", "category",
             "score"]


def word2vec(pkg, L):
    dict_size = len(ptt.dataset.imikolov.build_dict())
    words = [L.data("w%d" % i, shape=[1], dtype="int64")
             for i in range(W2V_N)]
    embs = [L.reshape(L.embedding(w, size=[dict_size, W2V_EMB],
                                  is_sparse=False,
                                  param_attr=pkg.ParamAttr(name="shared_w")),
                      [-1, W2V_EMB]) for w in words[:4]]
    hidden = L.fc(L.concat(embs, axis=1), size=W2V_HID, act="sigmoid")
    logits = L.fc(hidden, size=dict_size)
    avg = L.mean(L.softmax_with_cross_entropy(logits, words[4]))
    return avg, None, logits, pkg.optimizer.AdamOptimizer(learning_rate=1e-2)


def recommender_system(pkg, L):
    ml = ptt.dataset.movielens
    uid, gender, age, job, mid, cat = (
        L.data(n, shape=[1], dtype="int64") for n in MOVIELENS[:6])
    rating = L.data("score", shape=[1], dtype="float32")

    def tower(parts, size=32):
        feats = [L.reshape(e, [-1, int(e.shape[-1])]) for e in parts]
        return L.fc(L.concat(feats, axis=1), size=size, act="tanh")

    usr = tower([L.embedding(uid, [ml.USER_COUNT, 16]),
                 L.embedding(gender, [2, 8]),
                 L.embedding(age, [ml.AGE_COUNT, 8]),
                 L.embedding(job, [ml.JOB_COUNT, 8])])
    mov = tower([L.embedding(mid, [ml.MOVIE_COUNT, 16]),
                 L.embedding(cat, [ml.CATEGORY_COUNT, 8])])
    pred = L.scale(L.ops.cos_sim(usr, mov), scale=5.0)
    avg = L.mean(L.square_error_cost(pred, rating))
    return avg, None, pred, pkg.optimizer.AdamOptimizer(learning_rate=5e-3)


def _reader(name, b):
    """(feed names, the book's batch reader, image shape or None)."""
    ds = ptt.dataset
    if name == "word2vec":
        return (["w%d" % i for i in range(W2V_N)], ptt.batch(
            ds.imikolov.train(ds.imikolov.build_dict(), W2V_N), b), None)
    if name == "recommender_system":
        return MOVIELENS, ptt.batch(ds.movielens.train(), b), None
    if name == "fit_a_line":
        return ["x", "y"], ptt.batch(ds.uci_housing.train(), b), None
    if name == "vgg_lite":
        return ["img", "label"], ptt.batch(ds.cifar.train10(), b), (3, 32, 32)
    return ["img", "label"], ptt.batch(ds.mnist.train(), b), (1, 28, 28)


PROGRAMS = {"fit_a_line": (fit_a_line, 20), "lenet5": (lenet5, 16),
            "mnist_mlp": (mnist_mlp, 16), "vgg_lite": (vgg_lite, 8),
            "word2vec": (word2vec, 16),
            "recommender_system": (recommender_system, 32)}
# the feeds each saved inference program reads
SERVED = {"word2vec": ["w%d" % i for i in range(4)],
          "recommender_system": MOVIELENS[:6]}


def build(pkg, L, guard, fn):
    main, startup = pkg.Program(), pkg.Program()
    with guard(), pkg.program_guard(main, startup):
        loss, acc, out, opt = fn(pkg, L)
        test = main.clone(for_test=True)
        opt.minimize(loss)
    return main, startup, test, loss, acc, out


def feeds(name):
    names, reader, shape = _reader(name, PROGRAMS[name][1])
    out = []
    for batch in reader():
        feed = ptt.reader.to_feed(batch, names)
        if shape is not None:
            feed["img"] = feed["img"].reshape((-1,) + shape)
        if "score" in feed:
            feed["score"] = feed["score"].astype(np.float32)
        out.append(feed)
        if len(out) == STEPS + 1:
            return out


def carry(tmp_path, jmain, jstart, main, seed=0):
    """Initialize JAX's weights, perturb every parameter, the running
    statistics too (the variances by |noise|), save them with the JAX
    package's `save_persistables` and load them into a port scope with
    the port's `load_persistables`.  Returns (jexe, jscope, exe,
    scope)."""
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    rng = np.random.RandomState(seed)
    d = str(tmp_path / "persistables")
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        for v in jmain.all_parameters():
            a = np.asarray(jscope.find_var(v.name))
            noise = 0.1 * rng.standard_normal(a.shape)
            if not v.trainable and a.mean() == 1:
                noise = np.abs(noise)       # a running variance
            jscope.set(v.name, (a + noise).astype(a.dtype))
        jfluid.io.save_persistables(jexe, d, jmain)
    with fluid.scope_guard(scope):
        fluid.io.load_persistables(exe, d, main)
    return jexe, jscope, exe, scope


def _rel(a, b):
    scale = np.abs(b).max()
    return np.abs(a - b).max() / scale if scale else np.abs(a - b).max()


def _state_names(jmain):
    return [v.name for v in jmain.list_vars()
            if v.persistable and not v.is_data]


def _update_program(jmain):
    """The update ops of ``jmain`` alone, as a JAX program."""
    d = jmain.to_dict()
    for b in d["blocks"]:
        b["ops"] = [o for o in b["ops"]
                    if o["attrs"].get("op_role") == "optimize"]
    return jfluid.Program.from_dict(d)


def _stepped_from(jexe, upd, state, grads):
    """JAX's update ops applied to ``state`` (name -> array) with the
    gradients ``grads``: the state they leave."""
    scope = jfluid.Scope()
    for n, v in state.items():
        scope.set(n, v)
    with jfluid.scope_guard(scope):
        jexe.run(upd, feed=grads, fetch_list=[])
    return {n: np.asarray(scope.find_var(n)) for n in state}


def _bn_fed_biases(main):
    """Biases added right before a ``batch_norm``: the normalization
    removes them, so their gradient is 0 in exact arithmetic and
    rounding noise in either package."""
    block = main.global_block
    bn_in = {n for op in block.ops if op.type == "batch_norm"
             for n in op.input("X")}
    return {op.input("Y")[0] for op in block.ops
            if op.type == "elementwise_add" and op.output("Out")[0] in bn_in
            and block.var(op.input("Y")[0]).persistable}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_book_program_trains_as_jax(tmp_path, name):
    fn = PROGRAMS[name][0]
    jmain, jstart, jtest, jloss, jacc, jout = build(jfluid, jlayers,
                                                    jun.guard, fn)
    main, start, test, loss, acc, out = build(fluid, layers,
                                              unique_name.guard, fn)
    assert main.to_dict() == jmain.to_dict()
    assert start.to_dict() == jstart.to_dict()
    assert test.to_dict() == jtest.to_dict()
    jexe, jscope, exe, scope = carry(tmp_path, jmain, jstart, main)
    names = _state_names(jmain)
    for n in names:       # the carry, running statistics included
        np.testing.assert_array_equal(scope.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))
    stats = [p.name for p in jmain.all_parameters() if not p.trainable]
    held = {n: scope.find_var(n) for n in stats}
    start_stats = {n: t.clone() for n, t in held.items()}
    params = [p.name for p in jmain.all_parameters() if p.trainable]
    grads = [p + "@GRAD" for p in params]
    fetch = [jloss.name] + ([jacc.name] if jacc is not None else [])
    zero = {b + "@GRAD" for b in _bn_fed_biases(main)}
    upd = _update_program(jmain)
    data = feeds(name)
    for step, feed in enumerate(data[:STEPS]):
        before = {n: np.asarray(jscope.find_var(n)) for n in names}
        for n in names:           # both packages step from JAX's state
            scope.find_var(n).copy_(torch.from_numpy(before[n].copy()))
        with jfluid.scope_guard(jscope):
            jgot = jexe.run(jmain, feed=feed, fetch_list=fetch + grads)
        got = exe.run(main, feed=feed, fetch_list=fetch + grads, scope=scope)
        for f, g, w in zip(fetch, got, jgot):
            np.testing.assert_allclose(g, w, **LOSS_TOL,
                                       err_msg="%d %s" % (step, f))
        top = max(np.abs(w).max() for w in jgot[len(fetch):])
        for f, g, w in zip(grads, got[len(fetch):], jgot[len(fetch):]):
            if f in zero:
                assert max(np.abs(g).max(), np.abs(w).max()) \
                    <= SCALE_REL * top, (step, f)
            else:
                assert _rel(g, w) <= SCALE_REL, (step, f, _rel(g, w))
        alt = _stepped_from(jexe, upd, before,
                            dict(zip(grads, got[len(fetch):])))
        for n in names:
            g, w = scope.find_var(n).numpy(), np.asarray(jscope.find_var(n))
            scale = np.abs(w).max()
            err = np.minimum(np.abs(g - w), np.abs(g - alt[n])).max()
            assert err <= SCALE_REL * scale, (step, n, err / scale)
    assert len(stats) == 2 * (name == "vgg_lite")
    for n in stats:      # moved, in the scope's own tensors
        assert scope.find_var(n) is held[n]
        assert not torch.equal(held[n], start_stats[n])
    # the test clone (is_test: the running statistics) on the next batch,
    # from JAX's trained state
    for n in names:
        scope.find_var(n).copy_(torch.from_numpy(np.array(
            jscope.find_var(n))))
    feed = data[STEPS]
    with jfluid.scope_guard(jscope):
        jt = jexe.run(jtest, feed=feed, fetch_list=[jout.name])
    t = exe.run(test, feed=feed, fetch_list=[out.name], scope=scope)
    np.testing.assert_allclose(t[0], jt[0], **FWD)

    # save_inference_model / load_inference_model, then the Predictor
    # with both fuse passes against the unfused run
    in_names = SERVED.get(name, [n for n in feed if n in ("x", "img")])
    d = str(tmp_path / "model")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, in_names, [out], exe, main)
    scope2 = fluid.Scope()
    with fluid.scope_guard(scope2):
        prog, fnames, fvars = fluid.io.load_inference_model(d, exe)
    served = exe.run(prog, feed={n: feed[n] for n in fnames},
                     fetch_list=fvars, scope=scope2)
    np.testing.assert_allclose(served[0], jt[0], **FWD)
    jd = str(tmp_path / "jax_model")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(jd, in_names, [jout], jexe, jmain)
    from_jax = inference.create_predictor(inference.AnalysisConfig(jd),
                                          device="cpu")
    np.testing.assert_allclose(from_jax.run([feed[n] for n in in_names])[0],
                               jt[0], **FWD)
    pred = inference.create_predictor(inference.AnalysisConfig(d),
                                      device="cpu")
    plain = pred.run([feed[n] for n in fnames])
    ir.apply_passes(pred._program, ["batch_norm_act_fuse",
                                    "matmul_bias_act_fuse"])
    types = [o.type for o in pred._program.global_block.ops]
    fused = pred.run([feed[n] for n in fnames])
    np.testing.assert_allclose(fused[0], plain[0], **FWD)
    np.testing.assert_allclose(fused[0], jt[0], **FWD)
    assert "batch_norm" not in types
    if name in ("lenet5", "mnist_mlp"):
        assert types.count("matmul_bias_act") == 2
    if name == "vgg_lite":
        assert types.count("fused_batch_norm_act") == 1
    if name == "recommender_system":     # the two tanh towers
        assert types.count("matmul_bias_act") == 2
    if name == "word2vec":               # one table, one sigmoid fc
        assert [p.name for p in main.all_parameters()].count("shared_w") == 1
        assert types.count("matmul_bias_act") == 0


def _examples(reader):
    return [tuple(np.asarray(f) for f in ex) for ex in reader()]


@pytest.mark.parametrize("split", ["train", "test"])
def test_embedding_datasets_are_jax_bitwise(split):
    import paddle_tpu

    jds, ds = paddle_tpu.dataset, ptt.dataset
    assert ds.imikolov.build_dict() == jds.imikolov.build_dict()
    word_dict = ds.imikolov.build_dict()
    readers = [(getattr(ds.movielens, split)(),
                getattr(jds.movielens, split)())]
    for kind in (ds.imikolov.DataType.NGRAM, ds.imikolov.DataType.SEQ):
        readers.append((getattr(ds.imikolov, split)(word_dict, 5, kind),
                        getattr(jds.imikolov, split)(word_dict, 5, kind)))
    for got, want in readers:
        a, b = _examples(got), _examples(want)
        assert len(a) == len(b) > 0
        for ea, eb in zip(a, b):
            assert len(ea) == len(eb)
            for fa, fb in zip(ea, eb):
                assert fa.dtype == fb.dtype
                np.testing.assert_array_equal(fa, fb)
    for k in ("USER_COUNT", "MOVIE_COUNT", "JOB_COUNT", "AGE_COUNT",
              "CATEGORY_COUNT"):
        assert getattr(ds.movielens, k) == getattr(jds.movielens, k)
